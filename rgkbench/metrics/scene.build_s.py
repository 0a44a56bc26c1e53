"""Host seconds of the scene build: `SceneBuilder.timings`, summed
(load, SAH, clusters, upload)."""


def read(rec):
    return rec.get("build_s")
