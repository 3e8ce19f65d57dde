"""FlatScene: the device-resident SoA scene representation.

Array-table replacement for the reference's CUDA tagged-union scene
(CudaHittable Hittable.cuh:37-49, CudaMaterial Material.cuh:204-214,
CudaSceneContext arena CudaSceneContext.cuh:150-172): every primitive,
material, and texture is a row in a fixed-shape float32/int32 table, so the
whole scene is one JAX pytree living in HBM — virtual dispatch becomes masked
`jnp.where` selects over type-code columns.

Unified primitive ids: prim p in [0, n_spheres) is sphere p; p in
[n_spheres, n_spheres + n_quads) is quad p - n_spheres. Lights reference
prims by unified id.
"""
from __future__ import annotations

import jax.numpy as jnp

from ..utils import pytree

# material type codes
MAT_LAMBERTIAN, MAT_METAL, MAT_DIELECTRIC, MAT_DIFFUSE_LIGHT, MAT_ISOTROPIC = range(5)
# texture type codes
TEX_SOLID, TEX_CHECKER, TEX_NOISE = range(3)


@pytree.dataclass
class FlatScene:
    # --- spheres (S rows; padded rows have radius 0 and active False)
    sph_center: jnp.ndarray      # (S, 3) center at t=0
    sph_cdelta: jnp.ndarray      # (S, 3) center(t) = center + t * cdelta
    sph_radius: jnp.ndarray      # (S,)
    sph_mat: jnp.ndarray         # (S,) int32
    sph_active: jnp.ndarray      # (S,) bool

    # --- quads (Q rows), derived fields precomputed (reference Plane.cpp:6-26)
    quad_corner: jnp.ndarray     # (Q, 3)
    quad_u: jnp.ndarray          # (Q, 3)
    quad_v: jnp.ndarray          # (Q, 3)
    quad_normal: jnp.ndarray     # (Q, 3) unit
    quad_d: jnp.ndarray          # (Q,)  plane offset: dot(normal, corner)
    quad_w: jnp.ndarray          # (Q, 3) n/(n.n) for inside test
    quad_area: jnp.ndarray       # (Q,)
    quad_mat: jnp.ndarray        # (Q,) int32
    quad_active: jnp.ndarray     # (Q,) bool

    # --- lights (L rows of unified prim ids; MIS targets)
    light_prim: jnp.ndarray      # (L,) int32
    light_active: jnp.ndarray    # (L,) bool

    # --- constant mediums (M rows; ragged boundaries of MS spheres + MQ
    # quads, padded to the scene max — the span is the first two crossings
    # of the union, ConstantMedium.cpp:25-96 double-hit semantics)
    med_neg_inv_density: jnp.ndarray  # (M,)
    med_mat: jnp.ndarray              # (M,) int32 (isotropic material)
    med_sph_center: jnp.ndarray       # (M, MS, 3)
    med_sph_radius: jnp.ndarray       # (M, MS)  0 => inactive slot
    med_quad_corner: jnp.ndarray      # (M, 6, 3)
    med_quad_u: jnp.ndarray           # (M, 6, 3)
    med_quad_v: jnp.ndarray           # (M, 6, 3)
    med_quad_normal: jnp.ndarray      # (M, 6, 3)
    med_quad_d: jnp.ndarray           # (M, 6)
    med_quad_w: jnp.ndarray           # (M, 6, 3)
    med_quad_active: jnp.ndarray      # (M, 6) bool
    med_active: jnp.ndarray           # (M,) bool

    # --- materials
    mat_type: jnp.ndarray        # (NM,) int32
    mat_tex: jnp.ndarray         # (NM,) int32 texture index
    mat_fuzz: jnp.ndarray        # (NM,)
    mat_ior: jnp.ndarray         # (NM,)

    # --- textures
    tex_type: jnp.ndarray        # (NT,) int32
    tex_color: jnp.ndarray       # (NT, 3) solid color / metal-free slot
    tex_scale: jnp.ndarray       # (NT,) checker or noise scale
    tex_child_even: jnp.ndarray  # (NT,) int32
    tex_child_odd: jnp.ndarray   # (NT,) int32

    # --- hash-noise seed (shared per scene; utils/perlin.py derives lattice
    # gradients arithmetically from it — no permutation tables)
    perlin_seed: jnp.ndarray     # () uint32

    # --- flat BVH over unified prims (always present; 1-node dummy if unused)
    bvh_bbox_min: jnp.ndarray    # (B, 3)
    bvh_bbox_max: jnp.ndarray    # (B, 3)
    bvh_left: jnp.ndarray        # (B,) int32: left child (inner) / prim offset (leaf)
    bvh_right: jnp.ndarray       # (B,) int32: right child (inner) / prim count (leaf)
    bvh_axis: jnp.ndarray        # (B,) int32 split axis for near-child ordering
    bvh_leaf: jnp.ndarray        # (B,) bool
    bvh_prims: jnp.ndarray       # (P,) int32 leaf-ordered unified prim ids
    # sphere count within each leaf's prim run: build_bvh orders every leaf's
    # prims spheres-first, so a leaf splits into two typed runs
    bvh_leaf_sph: jnp.ndarray = None   # (B,) int32
    # stackless skip links (DFS order): hit = node to visit when this node's
    # box is hit (left child; unused for leaves), miss = node to visit when
    # missed / after a leaf (next sibling up the chain; B = end-of-walk),
    # for stackless per-ray traversal.
    bvh_hit: jnp.ndarray = None        # (B,) int32
    bvh_miss: jnp.ndarray = None       # (B,) int32

    # --- static metadata (compile-time constants)
    n_spheres: int = pytree.static_field(default=0)
    n_quads: int = pytree.static_field(default=0)
    n_lights: int = pytree.static_field(default=0)
    n_mediums: int = pytree.static_field(default=0)
    use_bvh: bool = pytree.static_field(default=False)
    # Perlin-noise textures present? Static so texture_value can skip the
    # 7-octave turbulence (8 table gathers per octave per ray) entirely for
    # noise-free scenes — with the scene as a traced jit argument XLA cannot
    # fold the dead branch.
    has_noise: bool = pytree.static_field(default=True)
    # Any moving sphere (center2)? (SphereKernels motion analogue.)
    has_motion: bool = pytree.static_field(default=True)
    # #(world-active, r>0, non-moving) spheres.
    n_sph_active_static: int = pytree.static_field(default=0)
    # Max checker-nesting depth in the texture DAG (CheckerTexture.cpp:14-55
    # allows recursive even/odd children). Static so texture_value can
    # resolve chains with a fixed unrolled loop: depth 1 = plain checkers,
    # 0 = none.
    checker_depth: int = pytree.static_field(default=1)
    # Texture DAG structure as a hashable compile-time constant: one
    # (type, even_child, odd_child) int triple per texture row (checker
    # children may be checkers/noise to any depth, CheckerTexture.cpp:14-55).
    tex_struct: tuple = pytree.static_field(default=())

    @property
    def n_prims(self) -> int:
        return self.n_spheres + self.n_quads
