"""Declarative scene + render configuration (TOML or JSON).

The reference hardcodes everything in ``main()`` — scene (kernel.cu:228-259),
resolution/spp (kernel.cu:262-266), camera (kernel.cu:311-322) — with a
"TODO: Load scene from file" marker (kernel.cu:261). This module is that TODO
done properly: a schema covering geometry (kind, OBJ path, TRS), materials
(all four BXDF types with the utilities.h:83-88 parameter set), the camera
block (utilities.h:271-291 fields), and the render block, sufficient to
express all five BASELINE.json workload configs (see ``scenes/``).
"""

from __future__ import annotations

import json
import os
import tomllib

from gpupathtracer_tpu.models.camera import Camera
from gpupathtracer_tpu.models.materials import BxdfType
from gpupathtracer_tpu.models.scene import (
    GeometrySpec,
    build_scene,
    mesh_spec,
    plane_spec,
    sphere_spec,
)
from gpupathtracer_tpu.render.renderer import RenderSettings

DEFAULT_ASSET_DIRS = ["/root/reference/sceneResources"]


def _find_asset(path: str, search_dirs: list[str]) -> str:
    if os.path.isabs(path) and os.path.exists(path):
        return path
    for d in search_dirs:
        cand = os.path.join(d, path)
        if os.path.exists(cand):
            return cand
    raise FileNotFoundError(f"asset {path!r} not found in {search_dirs}")


def load_config(path: str) -> dict:
    with open(path, "rb") as f:
        if path.endswith(".json"):
            return json.load(f)
        return tomllib.load(f)


def parse_config(cfg: dict, config_dir: str = "."):
    """Config dict → (geometry specs, material dicts, Camera, RenderSettings)."""
    search_dirs = [config_dir] + list(cfg.get("asset_dirs", [])) + DEFAULT_ASSET_DIRS

    materials = cfg.get("materials", [{"type": "diffuse", "albedo": [0.5, 0.5, 0.5]}])
    mat_index = {m.get("name", f"material_{i}"): i for i, m in enumerate(materials)}

    def mat_id_of(g: dict) -> int:
        m = g.get("material", 0)
        return mat_index[m] if isinstance(m, str) else int(m)

    def is_glass(mid: int) -> bool:
        t = materials[mid].get("type", "diffuse")
        return (t.upper() if isinstance(t, str) else t) in ("GLASS", BxdfType.GLASS)

    specs: list[GeometrySpec] = []
    for g in cfg.get("geometry", []):
        kind = g.get("kind", "mesh")
        mid = mat_id_of(g)
        pos = g.get("position", (0.0, 0.0, 0.0))
        rot = g.get("rotation_deg", (0.0, 0.0, 0.0))
        scl = g.get("scale", (1.0, 1.0, 1.0))
        if isinstance(scl, (int, float)):
            scl = (scl, scl, scl)
        if kind == "mesh":
            obj_path = _find_asset(g["obj"], search_dirs)
            mesh = obj_path
            if int(g.get("subdivide", 0)) > 0:
                from gpupathtracer_tpu.models.obj import load_obj, subdivide_mesh

                mesh = subdivide_mesh(load_obj(obj_path), int(g["subdivide"]))
            # Glass needs exit hits → force two-sided intersection.
            specs.append(
                mesh_spec(
                    mesh,
                    position=pos,
                    rotation_deg=rot,
                    scale=scl,
                    mat_id=mid,
                    two_sided=bool(g.get("two_sided", is_glass(mid))),
                )
            )
        elif kind == "plane":
            specs.append(plane_spec(pos, rot, scl, mat_id=mid))
        elif kind == "sphere":
            specs.append(
                sphere_spec(
                    position=pos,
                    radius=float(g.get("radius", 1.0)),
                    mat_id=mid,
                    subdivisions=int(g.get("subdivisions", 3)),
                )
            )
        else:
            raise ValueError(f"unknown geometry kind {kind!r}")

    cam_cfg = cfg.get("camera", {})
    rnd = cfg.get("render", {})
    width = int(rnd.get("width", 800))
    height = int(rnd.get("height", 800))
    camera = Camera.create(
        position=cam_cfg.get("position", (0.0, 0.0, 15.0)),
        yaw=cam_cfg.get("yaw", -90.0),
        pitch=cam_cfg.get("pitch", 0.0),
        world_up=cam_cfg.get("world_up", (0.0, 1.0, 0.0)),
        fov_deg=cam_cfg.get("fov_deg", 70.0),
        near_clip=cam_cfg.get("near_clip", 0.1),
        far_clip=cam_cfg.get("far_clip", 1000.0),
        width=width,
        height=height,
    )
    settings = RenderSettings(
        width=width,
        height=height,
        spp=int(rnd.get("spp", 1)),
        bounces=int(rnd.get("bounces", 1)),
        seed=int(rnd.get("seed", 1234)),
        jitter=bool(rnd.get("jitter", True)),
        background=tuple(rnd.get("background", (0.0, 0.0, 0.0))),
        aov=rnd.get("aov", "radiance"),
        rr_start=rnd.get("rr_start"),
        tri_block=int(rnd.get("tri_block", 512)),
        ray_chunk=int(rnd.get("ray_chunk", 8192)),
        use_shading_normals=bool(rnd.get("use_shading_normals", False)),
        intersector=rnd.get("intersector", "auto"),
        estimator=rnd.get("estimator", "naive"),
        sort_rays=(
            rnd.get("sort_rays", "auto")
            if rnd.get("sort_rays", "auto") == "auto"
            else bool(rnd.get("sort_rays"))
        ),
        sort_key=rnd.get("sort_key", "auto"),
        compact=bool(rnd.get("compact", True)),
        compact_mode=rnd.get("compact_mode", "permute"),
        rng=rnd.get("rng", "pcg"),
    )

    # Image textures: [[textures]] file = "foo.ppm" entries stack into the
    # scene's (T, H, W, 3) texture array (row order = texture_id); material
    # dicts reference rows via texture = "image", texture_id = i.
    textures = None
    tex_cfgs = cfg.get("textures", [])
    if tex_cfgs:
        import numpy as np

        from gpupathtracer_tpu.utils.image import read_ppm

        imgs = []
        for t in tex_cfgs:
            img = read_ppm(_find_asset(t["file"], search_dirs)).astype(np.float32) / 255.0
            imgs.append(img)
        shapes = {im.shape for im in imgs}
        assert len(shapes) == 1, f"texture sizes must match, got {shapes}"
        textures = np.stack(imgs)
    return specs, materials, camera, settings, textures


def load_scene_file(path: str, pad_to_multiple: int | None = None):
    """Load a config file → (TriangleScene, Camera, RenderSettings)."""
    cfg = load_config(path)
    specs, materials, camera, settings, textures = parse_config(
        cfg, os.path.dirname(os.path.abspath(path))
    )
    scene = build_scene(
        specs, materials, pad_to_multiple=pad_to_multiple or settings.tri_block,
        textures=textures,
    )
    return scene, camera, settings
