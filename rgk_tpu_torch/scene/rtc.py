"""Legacy line-based `.rtc` scene config (port of rgk_tpu/scene/rtc.py).

Format: a fixed header of 9 meaningful lines (comment, model file,
output file, recursion level, "xres yres", camera position, lookat,
up vector, yview), followed by free-form option lines:

    L x y z r g b intensity [size]     point light (color /255)
    multisample|ms N
    sky|skycolor r g b [brightness]    (color /255)
    lens|lenssize|lens_size S
    focus|focus_plane|focus_dist D
    bump_scale|bumpmap_scale|bump|bumpscale S
    clamp C          russian|roulette P      rounds N
    reverse N        brdf NAME               thinglass PHRASE
    force_fresnell 0|1

Unknown option lines warn instead of raising, as the reference does.
Blank lines and lines starting with '#' are skipped.  `load_config`
sends a `.rtc` file here only when its content is not JSON.
"""

from __future__ import annotations

import os

import numpy as np

from ..utils import log as out
from . import transforms as xf
from .camera import Camera, make_camera
from .config import Config, ConfigError, RenderSettings

# Legacy brdf names mapped onto the live material set; the value is not
# used when the model's materials are installed, but an unknown name
# raises.
_BRDF_NAMES = {
    "cooktorr": "cooktorr",
    "phong": "phong",
    "phong2": "phong2",
    "phongenergy": "phongenergy",
    "diffuse": "diffusecosine",
    "diffuseuniform": "diffuseuniform",
    "ltc_beckmann": "ltc_beckmann",
    "ltc_ggx": "ltc_ggx",
}


class ConfigRTC(Config):
    """Duck-types Config: settings / get_camera / install / post_check."""

    def __init__(self, path: str):  # noqa: super().__init__ replaced
        self.path = path
        self.configdir = os.path.dirname(os.path.abspath(path))
        self.root = None  # no JSON tree
        with open(path, "r") as f:
            raw_lines = f.read().splitlines()
        it = (ln.strip() for ln in raw_lines)

        def next_line():
            # Skips blanks and '#' comments.
            for ln in it:
                if ln and not ln.startswith("#"):
                    return ln
            raise ConfigError(f"Unexpected end of config file {path}")

        try:
            self.comment = raw_lines[0].strip() if raw_lines else ""
            next(it)  # the comment line (always consumed, even if blank)
        except StopIteration:
            raise ConfigError(f"Empty .rtc config file {path}")
        self.model_file = next_line()
        s = RenderSettings()
        s.output_file = next_line()
        s.recursion_max = int(next_line())
        res = next_line().split()
        if len(res) != 2:
            raise ConfigError("Invalid resolution format.")
        s.xres, s.yres = int(res[0]), int(res[1])
        if s.xres == 0 or s.yres == 0:
            raise ConfigError("Invalid output image resolution.")
        self._cam_pos = _vec3(next_line(), "VP")
        self._cam_lookat = _vec3(next_line(), "LA")
        self._cam_up = _vec3(next_line(), "UP")
        self._yview = float(next_line())
        if not (0.0 < self._yview < 100.0):
            raise ConfigError("Invalid yview value.")

        # Defaults differ from the JSON path: russian roulette is off
        # unless configured.
        s.russian = -1.0
        self._focus_plane = 1.0
        self._lens_size = 0.0
        self.brdf = ""
        self.lights = []   # (pos, color, intensity, size)
        self._sky_color = np.zeros(3)
        self._sky_brightness = 1.0

        for ln in it:
            vs = ln.split()
            if not vs or vs[0].startswith("#"):
                continue
            key = vs[0]
            if key == "L":
                if not 8 <= len(vs) <= 9:
                    raise ConfigError("Invalid light line.")
                pos = np.array([float(v) for v in vs[1:4]])
                color = np.array([float(v) / 255.0 for v in vs[4:7]])
                intensity = float(vs[7])
                size = float(vs[8]) if len(vs) == 9 else 0.0
                self.lights.append((pos, color, intensity, size))
            elif key in ("multisample", "ms"):
                s.multisample = int(vs[1])
                if s.multisample == 0:
                    raise ConfigError("Invalid multisample value.")
            elif key in ("sky", "skycolor"):
                if not 4 <= len(vs) <= 5:
                    raise ConfigError("Invalid sky color line.")
                self._sky_color = np.array(
                    [int(v) / 255.0 for v in vs[1:4]])
                if len(vs) == 5:
                    self._sky_brightness = float(vs[4])
            elif key in ("lens", "lenssize", "lens_size"):
                self._lens_size = float(vs[1])
                if self._lens_size < 0:
                    raise ConfigError("Lens size must be a positive value.")
            elif key in ("focus", "focus_plane", "focus_dist"):
                self._focus_plane = float(vs[1])
                if self._focus_plane < 0:
                    raise ConfigError(
                        "Focus plane must be a positive value.")
            elif key in ("bump_scale", "bumpmap_scale", "bump", "bumpscale"):
                s.bumpmap_scale = float(vs[1])
            elif key == "clamp":
                s.clamp = float(vs[1])
            elif key in ("russian", "roulette"):
                s.russian = float(vs[1])
            elif key == "rounds":
                s.rounds = int(vs[1])
            elif key == "reverse":
                s.reverse = int(vs[1])
            elif key == "brdf":
                if vs[1] not in _BRDF_NAMES:
                    raise ConfigError(f"Unknown BRDF type: {vs[1]}")
                self.brdf = _BRDF_NAMES[vs[1]]
            elif key == "thinglass":
                if len(vs) != 2:
                    raise ConfigError("Invalid thinglass config line.")
                s.thinglass.append(vs[1])
            elif key == "force_fresnell":
                s.force_fresnell = int(vs[1]) == 1
            else:
                out.log(2, f"WARNING: Unrecognized option `{key}` in the "
                           f"config file.")
        self.settings = s

    def get_camera(self, rotation: float = 0.0) -> Camera:
        """yview is given directly (not a fov); `rotation` orbits the
        position about the up axis through lookat."""
        s = self.settings
        position = self._cam_pos
        if rotation != 0.0:
            p = self._cam_lookat - position
            m = xf.rotate(rotation * 2.0 * np.pi, self._cam_up)
            position = self._cam_lookat - m[:3, :3] @ p
        xview = self._yview * s.xres / s.yres
        return make_camera(position, self._cam_lookat, self._cam_up,
                           self._yview, xview, s.xres, s.yres,
                           self._focus_plane, self._lens_size)

    def install(self, builder) -> None:
        modelfile = os.path.join(self.configdir, self.model_file)
        self._install_obj(builder, modelfile, import_materials=True,
                          override_materials=False, forced_material="",
                          smooth_normals=False, transform=None)
        for pos, color, intensity, size in self.lights:
            builder.add_point_light(pos, color, intensity, size)
        builder.set_sky_color(self._sky_color, self._sky_brightness)
        builder.make_thinglass_set(self.settings.thinglass)

    def post_check(self) -> None:
        pass  # no JSON keys to lint


def _vec3(line: str, what: str) -> np.ndarray:
    vs = line.split()
    if len(vs) != 3:
        raise ConfigError(f"Invalid {what} format.")
    return np.array([float(v) for v in vs])
