"""Declarative scene description (host side) with JSON round-trip.

This is the user-facing scene model, replacing the reference's shared_ptr
object graph (src/core/objects/Hittable.hpp + src/main.cpp scene builders).
The reference README promises JSON scene configuration but never implements a
parser (README.md:18 vs. no parser anywhere); here JSON is the primary scene
format. A schema scene is *compiled* to flattened SoA device arrays by
scene/compile.py — the analogue of the reference's CPU→CUDA scene
conversion pass (HittableConverter.cuh:37-240).
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field, asdict
from typing import Optional

Vec = tuple[float, float, float]


# ---------------------------------------------------------------- textures
@dataclass
class SolidColor:
    """Constant color (reference: SolidColorTexture.cpp:8-10)."""
    albedo: Vec
    kind: str = "solid"


@dataclass
class Checker:
    """3D checker on floor(p/scale) parity (reference: CheckerTexture.cpp:14-55).

    Children may be any texture; the compiled evaluator supports one level of
    nesting (solid/noise children), which covers every reference scene.
    """
    scale: float
    even: "Texture"
    odd: "Texture"
    kind: str = "checker"


@dataclass
class Noise:
    """Marble texture 0.5*(1+sin(scale*z + 10*turb(p))) (NoiseTexture.cpp:8-33)."""
    scale: float
    kind: str = "noise"


Texture = SolidColor | Checker | Noise


# ---------------------------------------------------------------- materials
@dataclass
class Lambertian:
    """Cosine-weighted diffuse (reference: LambertianMaterial.cpp)."""
    texture: Texture
    kind: str = "lambertian"


@dataclass
class Metal:
    """Mirror + fuzz, skip_pdf (reference: MetalMaterial.cpp)."""
    albedo: Vec
    fuzz: float = 0.0
    kind: str = "metal"


@dataclass
class Dielectric:
    """Snell + Schlick glass, skip_pdf (reference: DielectricMaterial.cpp)."""
    refraction_index: float
    kind: str = "dielectric"


@dataclass
class DiffuseLight:
    """Front-face-only emitter, never scatters (DiffuseLightMaterial.cpp:12-23)."""
    texture: Texture
    kind: str = "diffuse_light"


@dataclass
class Isotropic:
    """Uniform-sphere phase function (IsotropicMaterial.cpp:12-31)."""
    texture: Texture
    kind: str = "isotropic"


Material = Lambertian | Metal | Dielectric | DiffuseLight | Isotropic


# ---------------------------------------------------------------- objects
@dataclass
class Sphere:
    """Static or moving sphere; center2 enables motion blur over t in [0,1)
    (reference: Sphere.cpp:15-23 stores center as a Ray)."""
    center: Vec
    radius: float
    material: Material
    center2: Optional[Vec] = None
    kind: str = "sphere"


@dataclass
class Quad:
    """Parallelogram corner + a*u + b*v, a,b in [0,1] (reference: Plane.cpp)."""
    corner: Vec
    u: Vec
    v: Vec
    material: Material
    kind: str = "quad"


@dataclass
class Box:
    """Axis-aligned box -> 6 quads (reference: PlaneUtility.hpp:11-39 make_box)."""
    a: Vec
    b: Vec
    material: Material
    kind: str = "box"


@dataclass
class Translate:
    """Instance translation, baked into primitive params at compile time
    (reference: Translate.cpp offsets the ray at trace time instead)."""
    child: "SceneObject"
    offset: Vec
    kind: str = "translate"


@dataclass
class RotateY:
    """Y-axis rotation instance, baked at compile time (reference: RotateY.cpp)."""
    child: "SceneObject"
    angle_degrees: float
    kind: str = "rotate_y"


@dataclass
class Group:
    """A list of child objects treated as one (the reference's HittableList
    used compositionally, HittableList.cpp:26-42) — e.g. a multi-part
    constant-medium boundary."""
    children: list = field(default_factory=list)
    kind: str = "group"


@dataclass
class ConstantMedium:
    """Constant-density participating medium inside a convex boundary
    (reference: ConstantMedium.cpp:25-96). The boundary does not itself render;
    it only bounds exponential free-flight sampling."""
    boundary: "SceneObject"
    density: float
    texture: Texture
    kind: str = "constant_medium"


SceneObject = Sphere | Quad | Box | Translate | RotateY | Group \
    | ConstantMedium


# ---------------------------------------------------------------- camera
@dataclass
class CameraConfig:
    """Union of the reference's CLIOptions + CameraConfig
    (src/input/CLI.hpp:8-51, src/core/camera/CameraConfig.hpp:9-63)."""
    aspect_ratio: float = 1.0
    image_width: int = 600
    samples_per_pixel: int = 100
    max_depth: int = 50
    vfov: float = 40.0
    lookfrom: Vec = (0.0, 0.0, 0.0)
    lookat: Vec = (0.0, 0.0, -1.0)
    vup: Vec = (0.0, 1.0, 0.0)
    defocus_angle: float = 0.0
    focus_dist: float = 10.0
    background: Vec = (0.0, 0.0, 0.0)
    # Sky-gradient background (RTiOW-style lerp white->blue) instead of the
    # constant background color. Off for all reference-parity scenes.
    sky_gradient: bool = False


@dataclass
class Scene:
    objects: list = field(default_factory=list)
    lights: list = field(default_factory=list)  # subset of objects, MIS targets
    camera: CameraConfig = field(default_factory=CameraConfig)
    name: str = "scene"
    perlin_seed: int = 0


# ---------------------------------------------------------------- JSON I/O
_TEXTURES = {"solid": SolidColor, "checker": Checker, "noise": Noise}
_MATERIALS = {"lambertian": Lambertian, "metal": Metal, "dielectric": Dielectric,
              "diffuse_light": DiffuseLight, "isotropic": Isotropic}
_OBJECTS = {"sphere": Sphere, "quad": Quad, "box": Box, "translate": Translate,
            "rotate_y": RotateY, "group": Group,
            "constant_medium": ConstantMedium}


def _from_dict(d, registry):
    cls = registry[d["kind"]]
    kwargs = dict(d)
    kwargs.pop("kind")
    for k, v in kwargs.items():
        if isinstance(v, dict) and "kind" in v:
            if v["kind"] in _TEXTURES:
                kwargs[k] = _from_dict(v, _TEXTURES)
            elif v["kind"] in _MATERIALS:
                kwargs[k] = _from_dict(v, _MATERIALS)
            else:
                kwargs[k] = _from_dict(v, _OBJECTS)
        elif isinstance(v, list) and v and isinstance(v[0], dict) \
                and "kind" in v[0]:
            kwargs[k] = [_from_dict(c, _OBJECTS) for c in v]
    return cls(**kwargs)


def scene_to_json(scene: Scene) -> str:
    d = {
        "name": scene.name,
        "perlin_seed": scene.perlin_seed,
        "camera": asdict(scene.camera),
        "objects": [asdict(o) for o in scene.objects],
        "lights": [asdict(o) for o in scene.lights],
    }
    return json.dumps(d, indent=2)


def scene_from_json(text: str) -> Scene:
    d = json.loads(text)
    cam = CameraConfig(**{k: tuple(v) if isinstance(v, list) else v
                          for k, v in d["camera"].items()})
    objs = [_from_dict(o, _OBJECTS) for o in d["objects"]]
    # Lights duplicate object descriptions; identity with world objects is not
    # required (the reference also re-lists lights: src/main.cpp:58-66).
    lights = [_from_dict(o, _OBJECTS) for o in d.get("lights", [])]
    return Scene(objects=objs, lights=lights, camera=cam,
                 name=d.get("name", "scene"), perlin_seed=d.get("perlin_seed", 0))


def save_scene(scene: Scene, path: str):
    with open(path, "w") as f:
        f.write(scene_to_json(scene))


def load_scene(path: str) -> Scene:
    with open(path) as f:
        return scene_from_json(f.read())
