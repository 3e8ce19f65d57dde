"""Scene complexity analysis and debug report.

Analogue of the reference's scene analyzer
(CudaSceneInitialization.cuh:114-246: recursive object-graph walk counting
hittable types + unique materials/textures, memory estimate with overhead,
debug dump to logs/cuda_scene_complexity_debug.txt :74-104). Here the
"device format" is the FlatScene SoA pytree, so the analysis is exact table
accounting rather than a pointer-graph estimate.
"""
from __future__ import annotations

import numpy as np

from . import schema as S
from .flat import FlatScene


def count_objects(obj, counts: dict) -> None:
    """Recursive schema-graph walk (reference analyze_hittable_complexity)."""
    name = type(obj).__name__
    counts[name] = counts.get(name, 0) + 1
    if isinstance(obj, (S.Translate, S.RotateY)):
        count_objects(obj.child, counts)
    elif isinstance(obj, S.ConstantMedium):
        count_objects(obj.boundary, counts)


def analyze(scene: S.Scene, flat: FlatScene | None = None) -> dict:
    """Complexity report: schema object counts + compiled table accounting."""
    counts: dict = {}
    for obj in scene.objects:
        count_objects(obj, counts)

    report = {
        "scene": scene.name,
        "objects": counts,
        "n_lights": len(scene.lights),
    }
    if flat is not None:
        tables = {}
        total = 0
        for name in flat.__dataclass_fields__:
            v = getattr(flat, name)
            if hasattr(v, "shape"):
                arr = np.asarray(v)
                tables[name] = dict(shape=list(arr.shape),
                                    dtype=str(arr.dtype),
                                    bytes=int(arr.nbytes))
                total += arr.nbytes
        report["compiled"] = dict(
            n_spheres=flat.n_spheres, n_quads=flat.n_quads,
            n_lights=flat.n_lights, n_mediums=flat.n_mediums,
            n_materials=int(flat.mat_type.shape[0]),
            n_textures=int(flat.tex_type.shape[0]),
            bvh_nodes=int(flat.bvh_leaf.shape[0]) if flat.use_bvh else 0,
            device_bytes=total,
            tables=tables,
        )
    return report


def format_report(report: dict) -> str:
    """Human-readable dump (reference: output_debug_info, the
    logs/cuda_scene_complexity_debug.txt format)."""
    lines = [f"=== Scene Complexity: {report['scene']} ===", "", "Objects:"]
    for name, n in sorted(report["objects"].items()):
        lines.append(f"  {name}: {n}")
    lines.append(f"  lights list: {report['n_lights']}")
    if "compiled" in report:
        c = report["compiled"]
        lines += [
            "",
            "Compiled FlatScene:",
            f"  spheres: {c['n_spheres']}  quads: {c['n_quads']}  "
            f"lights: {c['n_lights']}  mediums: {c['n_mediums']}",
            f"  materials: {c['n_materials']}  textures: {c['n_textures']}"
            f"  bvh nodes: {c['bvh_nodes']}",
            f"  device memory: {c['device_bytes'] / 1024:.1f} KiB "
            f"across {len(c['tables'])} tables",
            "",
            "Largest tables:",
        ]
        top = sorted(c["tables"].items(), key=lambda kv: -kv[1]["bytes"])[:8]
        for name, t in top:
            lines.append(f"  {name:20s} {str(t['shape']):>14s} "
                         f"{t['dtype']:>8s} {t['bytes']:>10d} B")
    return "\n".join(lines) + "\n"


def dump_report(scene: S.Scene, flat: FlatScene | None, path: str) -> str:
    text = format_report(analyze(scene, flat))
    with open(path, "w") as f:
        f.write(text)
    return text
