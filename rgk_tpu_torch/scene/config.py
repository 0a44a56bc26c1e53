"""Scene configuration: the reference's JSON schema (port of
rgk_tpu/scene/config.py).

Parses render settings, camera, materials, scene objects (built-in
primitives or OBJ files with transforms), point lights and sky, and
drives a `SceneBuilder`.  Legacy line-based `.rtc` configs load
through `scene/rtc.py` `ConfigRTC`.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from ..io import load_obj
from ..utils import log as out
from . import primitives as prims
from . import transforms as xf
from .arrays import (
    BSDF_DIELECTRIC,
    BSDF_DIFFUSE,
    BSDF_LTC_BECKMANN,
    BSDF_LTC_BECKMANN_DIFFUSE,
    BSDF_LTC_GGX,
    BSDF_LTC_GGX_DIFFUSE,
    BSDF_MIRROR,
    BSDF_MIX,
    BSDF_NAMES,
    BSDF_TRANSPARENT,
)
from .builder import (FLAT_MAX_TRIANGLES, MaterialSpec, SceneBuilder,
                      phong_exponent_to_roughness)
from .camera import Camera, make_camera
from .json_utils import ConfigError, Node, loads_tolerant


@dataclass
class RenderSettings:
    """Render parameters (the reference's defaults)."""
    output_file: str = "output.exr"
    xres: int = 512
    yres: int = 512
    rounds: int = 1
    render_minutes: float = 0.0
    timed: bool = False
    recursion_max: int = 40
    multisample: int = 1
    clamp: float = 10000000.0
    bumpmap_scale: float = 1.0
    russian: float = 0.74
    reverse: int = 0
    force_fresnell: bool = False
    # -1 selects auto exposure (max channel -> 1.0).
    output_scale: float = -1.0
    thinglass: List[str] = field(default_factory=list)
    tint_thinglass: bool = False


class Config:
    """A parsed scene JSON + installation into a SceneBuilder."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "r") as f:
            data = loads_tolerant(f.read())
        self.root = Node(data, "the config file")
        self.configdir = os.path.dirname(os.path.abspath(path))
        self.settings = self._parse_settings()

    def _parse_settings(self) -> RenderSettings:
        r = self.root
        s = RenderSettings()
        s.output_file = r.req_str("output-file")
        s.xres = r.req_int("output-width")
        s.yres = r.req_int("output-height")
        if r.has("rounds") and r.has("render-time"):
            raise ConfigError(
                'The config file may not contain both "rounds" and '
                '"render-time" keys simultaneously.')
        if r.has("rounds"):
            s.rounds = r.req_int("rounds")
        elif r.has("render-time"):
            s.timed = True
            s.render_minutes = r.req_float("render-time")
        s.recursion_max = r.opt_int("recursion-max", 40)
        s.multisample = r.opt_int("multisample", 1)
        s.clamp = r.opt_float("clamp", 10000000.0)
        s.bumpmap_scale = r.opt_float("bumpscale", 1.0)
        s.russian = r.opt_float("russian", 0.74)
        s.reverse = r.opt_int("reverse", 0)
        s.force_fresnell = r.opt_bool("force-fresnell", False)
        if r.has("output-scale"):
            v = r.raw("output-scale")
            if v == "auto":
                s.output_scale = -1.0
            elif isinstance(v, (int, float)) and not isinstance(v, bool):
                s.output_scale = float(v)
            else:
                raise ConfigError(
                    'The value of "output-scale" must either be a number, '
                    'or "auto".')
        if r.has("thinglass"):
            v = r.raw("thinglass")
            if not isinstance(v, list) or not all(isinstance(x, str) for x in v):
                raise ConfigError('Value "thinglass" must be an array of strings')
            s.thinglass = list(v)
        s.tint_thinglass = r.opt_bool("tint-thinglass", False)
        return s

    def get_camera(self, rotation: float = 0.0) -> Camera:
        """Camera from config; `rotation` in [0,1) orbits the position
        about the up-axis through lookat."""
        if not self.root.has("camera"):
            raise ConfigError('Value "camera" is missing.')
        cam = self.root.child("camera", "camera configuration")
        position = cam.req_vec3("position")
        lookat = cam.req_vec3("lookat")
        up = cam.opt_vec3("upvector", (0.0, 1.0, 0.0))
        s = self.settings
        if cam.has("focal"):
            yview = cam.req_float("focal")
            xview = yview * s.xres / s.yres
        elif cam.has("fov"):
            xview = 2.0 * np.tan(cam.req_float("fov") * 0.0174533 / 2.0)
            yview = xview * s.yres / s.xres
        else:
            raise ConfigError(
                'Camera must either have a "fov" or "focal" key defined')
        focus_plane = cam.opt_float("focus-plane", 1.0)
        lens_size = cam.opt_float("lens-size", 0.0)

        if rotation != 0.0:
            p = lookat - position
            m = xf.rotate(rotation * 2.0 * np.pi, up)
            position = lookat - m[:3, :3] @ p
        return make_camera(position, lookat, up, yview, xview,
                           s.xres, s.yres, focus_plane, lens_size)

    def install(self, builder: SceneBuilder) -> None:
        """Install materials, scene objects, lights and sky; then
        resolve the thin-glass set.  Unused-key linting (post_check)
        runs after get_camera() so the camera keys count as used."""
        self.install_materials(builder)
        self.install_scene(builder)
        self.install_lights(builder)
        self.install_sky(builder)
        builder.make_thinglass_set(self.settings.thinglass)

    def install_materials(self, builder: SceneBuilder) -> None:
        if not self.root.has("materials"):
            return
        for node in self.root.child_list("materials", "material"):
            spec = material_from_json(node, builder, self.configdir)
            builder.register_material(spec, override=True)

    def install_lights(self, builder: SceneBuilder) -> None:
        if not self.root.has("lights"):
            return
        for node in self.root.child_list("lights", "light"):
            builder.add_point_light(
                pos=node.req_vec3("position"),
                color=node.opt_vec3_255("color", (1.0, 1.0, 1.0)),
                intensity=node.req_float("intensity"),
                size=node.opt_float("size", 0.0),
            )

    def install_sky(self, builder: SceneBuilder) -> None:
        if not self.root.has("sky"):
            builder.set_sky_color(np.zeros(3), 1.0)
            return
        sky = self.root.child("sky", "sky configuration")
        if sky.has("envmap"):
            path = os.path.join(self.configdir, sky.req_str("envmap"))
            builder.set_sky_envmap(path, sky.opt_float("intensity", 1.0),
                                   sky.opt_float("rotate", 0.0))
        elif sky.has("color") or sky.has("color255"):
            builder.set_sky_color(sky.req_vec3_255("color"),
                                  sky.opt_float("intensity", 1.0))
        else:
            raise ConfigError(
                'Sky configuration must either contain an "envmap" key '
                'or a "color" key')

    def install_scene(self, builder: SceneBuilder) -> None:
        r = self.root
        if r.has("model-file") and r.has("scene"):
            raise ConfigError(
                'The input file may not contain both "model-file" key and '
                '"scene" key, maximum one of these is allowed.')
        if r.has("model-file"):
            modelfile = os.path.join(self.configdir, r.req_str("model-file"))
            self._install_obj(builder, modelfile, import_materials=True,
                              override_materials=False, forced_material="",
                              smooth_normals=False, transform=None)
        elif r.has("scene"):
            for obj in r.child_list("scene", "scene object"):
                self._install_object(builder, obj)
        else:
            raise ConfigError(
                'The input file contains neither "scene" nor "model-file" key.')

    def _install_object(self, builder: SceneBuilder, obj: Node) -> None:
        if obj.has("file") and obj.has("primitive"):
            raise ConfigError(
                f'Both "file" and "primitive" keys found in {obj.name}, '
                f'only one can be present at a time.')
        if obj.has("file"):
            modelfile = os.path.join(self.configdir, obj.req_str("file"))
            transform = xf.object_transform(
                obj.opt_vec3("scale", (1.0, 1.0, 1.0)),
                obj.opt_vec3("rotate", (0.0, 0.0, 0.0)),
                obj.opt_vec3("translate", (0.0, 0.0, 0.0)))
            self._install_obj(
                builder, modelfile,
                import_materials=obj.opt_bool("import-materials", False),
                override_materials=obj.opt_bool("override-materials", False),
                forced_material=obj.opt_str("material", ""),
                smooth_normals=obj.opt_bool("smooth-normals", False),
                transform=transform)
            obj.opt_str("brdf", "")  # consumed (assimp-path brdf hint)
        elif obj.has("primitive"):
            ptype = obj.req_str("primitive")
            if ptype not in prims.PRIMITIVES:
                raise ConfigError(
                    f'Value "primitive" in {obj.name} must be either '
                    f"'cube' or 'plane'.")
            pos, nrm, uv, tan = prims.PRIMITIVES[ptype]()
            pre = xf.identity()
            if ptype == "cube":
                pre = xf.scale((0.5, 0.5, 0.5)) @ pre
            pre = xf.axis_pre_transform(obj.opt_str("axis", "Y")) @ pre
            transform = xf.object_transform(
                obj.opt_vec3("scale", (1.0, 1.0, 1.0)),
                obj.opt_vec3("rotate", (0.0, 0.0, 0.0)),
                obj.opt_vec3("translate", (0.0, 0.0, 0.0)),
                pre=pre)
            texscale = obj.opt_vec3("texture-scale", (1.0, 1.0, 1.0))
            ttf = np.diag([texscale[0], texscale[1], 1.0])
            material = obj.req_str("material")
            builder.add_soup(pos, nrm, uv, tan, material,
                             transform=transform, texture_transform=ttf)
            out.log(2, f"Added a primitive with {pos.shape[0] // 3} faces.")
        else:
            raise ConfigError(
                f'Missing mesh data in {obj.name}, it must either contain '
                f'a "file" key, or "primitive" key.')

    def _install_obj(self, builder: SceneBuilder, modelfile: str,
                     import_materials: bool, override_materials: bool,
                     forced_material: str, smooth_normals: bool,
                     transform: Optional[np.ndarray]) -> None:
        if not os.path.exists(modelfile):
            raise ConfigError(f'Unable to find model file "{modelfile}"')
        modeldir = os.path.dirname(modelfile)
        meshes, mtl = load_obj(modelfile, smooth_normals=smooth_normals)
        if import_materials:
            for m in mtl.values():
                spec = mtl_to_material(m, builder, modeldir)
                builder.register_material(spec, override=override_materials)
        for mesh in meshes:
            mat_name = forced_material or mesh.material
            if mat_name == "":
                # Material-less OBJ group: give it a neutral diffuse.
                mat_name = "__obj_default"
                if mat_name not in builder.material_index:
                    builder.register_material(MaterialSpec(name=mat_name))
            positions = mesh.positions.astype(np.float64)
            normals = mesh.normals.astype(np.float64)
            tangents = mesh.tangents.astype(np.float64)
            if transform is not None:
                positions = xf.apply_points(transform, positions)
                normals = xf.apply_vectors(transform, normals,
                                           renormalize=False)
                tangents = xf.apply_vectors(transform, tangents,
                                            renormalize=False)
            builder.add_mesh(positions, normals, mesh.uvs, tangents,
                             mesh.faces, mat_name)

    def post_check(self) -> None:
        unused = self.root.find_unused()
        if unused:
            out.log(2, "WARNING: Following configuration values are present "
                       "in the config file,")
            out.log(2, "but were not used when loading the file. Please "
                       "check them for typos.")
            for k in unused:
                out.log(2, f"    {k}")


def material_from_json(node: Node, builder: SceneBuilder,
                       texturedir: str) -> MaterialSpec:
    """Parse one material entry, with the reference's per-BxDF
    default colors."""
    spec = MaterialSpec(name=node.req_str("name"))
    spec.emission = node.opt_vec3_255("emission", (0.0, 0.0, 0.0))
    bump = node.opt_str("bump-map", "")
    if bump:
        spec.bump_tex = builder.get_texture(os.path.join(texturedir, bump))
    spec.no_russian = node.opt_bool("no-russian", False)

    brdf = node.req_str("brdf")
    if brdf not in BSDF_NAMES:
        raise ConfigError("Unsupported BRDF id in config!")
    spec.bxdf = BSDF_NAMES[brdf]
    t = spec.bxdf

    def tex_or_color(tex_keys, color_key, default):
        """-> (tex_id, solid_color): texture file keys win, then the
        color (with 255 variant), then the per-BxDF default."""
        for k in tex_keys:
            f = node.opt_str(k, "")
            if f:
                return builder.get_texture(os.path.join(texturedir, f)), \
                    np.asarray(default, np.float32)
        if node.has(color_key) or node.has(color_key + "255"):
            return -1, node.req_vec3_255(color_key)
        return -1, np.asarray(default, np.float32)

    def specular_color(default):
        tex, col = tex_or_color(["color-texture", "specular-texture"],
                                "color", default)
        if tex < 0 and not node.has("color") and not node.has("color255") \
                and (node.has("specular") or node.has("specular255")):
            col = node.req_vec3_255("specular")
        return tex, col

    if t == BSDF_DIFFUSE:
        spec.diffuse_tex, spec.diffuse = tex_or_color(
            ["diffuse-texture"], "diffuse", (0.5, 0.5, 0.5))
    elif t == BSDF_MIRROR:
        spec.specular_tex, spec.specular = tex_or_color(
            ["color-texture"], "color", (1.0, 1.0, 1.0))
    elif t == BSDF_TRANSPARENT:
        pass
    elif t == BSDF_DIELECTRIC:
        spec.ior = node.req_float("ior")
        spec.specular_tex, spec.specular = specular_color((1.0, 1.0, 1.0))
    elif t in (BSDF_LTC_BECKMANN, BSDF_LTC_GGX,
               BSDF_LTC_BECKMANN_DIFFUSE, BSDF_LTC_GGX_DIFFUSE):
        if node.has("roughness"):
            spec.roughness = node.req_float("roughness")
        elif node.has("exponent"):
            spec.roughness = phong_exponent_to_roughness(
                node.req_float("exponent"))
        else:
            raise ConfigError(
                f'Either "roughness" or "exponent" must be present for '
                f'LTC BxDF in {node.name}')
        spec.specular_tex, spec.specular = specular_color((0.0, 0.0, 0.0))
        if t in (BSDF_LTC_BECKMANN_DIFFUSE, BSDF_LTC_GGX_DIFFUSE):
            spec.diffuse_tex, spec.diffuse = tex_or_color(
                ["diffuse-texture"], "diffuse", (0.0, 0.0, 0.0))
    elif t == BSDF_MIX:
        spec.mix_m1 = node.req_str("material1")
        spec.mix_m2 = node.req_str("material2")
        for m in (spec.mix_m1, spec.mix_m2):
            if m not in builder.material_index:
                raise ConfigError(
                    f'Material "{m}", used for mixing, was not (yet) defined')
            # The runtime expands exactly one mix level (ops/bxdf.py),
            # where a nested mix leaf would evaluate to zero: reject it.
            if builder.materials[builder.material_index[m]].bxdf \
                    == BSDF_MIX:
                raise ConfigError(
                    f'Material "{m}" is itself a mix: nested mix '
                    f'materials are not supported (mix leaves must be '
                    f'non-mix BxDFs)')
        spec.mix_amt = node.req_float("amount")
    return spec


def mtl_to_material(m, builder: SceneBuilder, texturedir: str) -> MaterialSpec:
    """MTL material -> LTC-GGX+diffuse, as the reference's assimp
    import does: roughness = sqrt(2/(2+Ns/4)), diffuse/specular colors
    or textures, Ke emission, bump map."""
    spec = MaterialSpec(name=m.name)
    spec.bxdf = BSDF_LTC_GGX_DIFFUSE
    spec.emission = np.asarray(m.emission, np.float32)
    spec.roughness = phong_exponent_to_roughness(m.shininess / 4.0)
    spec.diffuse = np.asarray(m.diffuse, np.float32)
    spec.specular = np.asarray(m.specular, np.float32)
    if m.diffuse_map:
        spec.diffuse_tex = builder.get_texture(
            os.path.join(texturedir, m.diffuse_map))
    if m.specular_map:
        spec.specular_tex = builder.get_texture(
            os.path.join(texturedir, m.specular_map))
    if m.bump_map:
        spec.bump_tex = builder.get_texture(
            os.path.join(texturedir, m.bump_map))
    return spec


def load_config(path: str) -> Config:
    """Load a scene config: JSON (`Config`) or line-based `.rtc`
    (`ConfigRTC`).  A `.rtc` file whose content is JSON loads as JSON,
    as in the reference."""
    if path.endswith(".rtc"):
        with open(path, "r") as f:
            head = f.read(64).lstrip()
        if not head.startswith("{"):
            from .rtc import ConfigRTC
            return ConfigRTC(path)
    return Config(path)


def build_scene(config: Config, device, build_bvh: bool = True,
                bvh_threshold: int = FLAT_MAX_TRIANGLES):
    """config -> (SceneArrays on `device`, SceneMeta, SceneBuilder).
    `build_bvh` / `bvh_threshold` as in `SceneBuilder.commit`."""
    builder = SceneBuilder()
    with builder.phase("load"):
        config.install(builder)
    arrays, meta = builder.commit(device=device, build_bvh=build_bvh,
                                  bvh_threshold=bvh_threshold)
    return arrays, meta, builder
