"""Small scenes shared by the tests, each exercising one structural case of
the renderer: textures, every material, media, many lights, many prims.
All at <= 32 px and depth <= 8 so they run on the CPU in seconds."""
import numpy as np

import real_time_ray_tracing_engine_tpu as rt
from real_time_ray_tracing_engine_tpu.scene import builders


def _cam(width, **kw):
    base = dict(aspect_ratio=1.0, image_width=width, samples_per_pixel=4,
                max_depth=4)
    base.update(kw)
    return rt.CameraConfig(**base)


def _light_sphere(y=8.0, r=2.0, e=6.0):
    return rt.Sphere((0, y, 0), r, rt.DiffuseLight(rt.SolidColor((e, e, e))))


def noise(width=32):
    """textured_spheres: Perlin marble + checker ground."""
    s = builders.textured_spheres()
    s.camera.image_width = width
    s.camera.samples_per_pixel = 4
    s.camera.max_depth = 4
    return s


def materials(width=32):
    """Lambertian/metal/dielectric + checker + sphere light + DOF + motion
    blur in one image."""
    checker = rt.Checker(2.0, rt.SolidColor((0.2, 0.3, 0.1)),
                         rt.SolidColor((0.9, 0.9, 0.9)))
    light = rt.Sphere((0, 6, 0), 2.0,
                      rt.DiffuseLight(rt.SolidColor((4, 4, 4))))
    return rt.Scene(objects=[
        rt.Sphere((0, -1000, 0), 1000.0, rt.Lambertian(checker)),
        rt.Sphere((0, 1, 0), 1.0, rt.Dielectric(1.5)),
        rt.Sphere((-4, 1, 0), 1.0,
                  rt.Lambertian(rt.SolidColor((0.4, 0.2, 0.1))),
                  center2=(-4, 1.3, 0)),
        rt.Sphere((4, 1, 0), 1.0, rt.Metal((0.7, 0.6, 0.5), fuzz=0.1)),
        light], lights=[light],
        camera=_cam(width, aspect_ratio=16 / 9, vfov=20,
                    lookfrom=(13, 2, 3), lookat=(0, 0, 0),
                    defocus_angle=0.6, focus_dist=10.0,
                    background=(0.7, 0.8, 1.0)), name="materials")


def nested_checker(width=24):
    """Texture-DAG recursion: a checker of a checker and Perlin marble."""
    inner = rt.Checker(0.31, rt.SolidColor((0.9, 0.1, 0.1)),
                       rt.SolidColor((0.1, 0.1, 0.9)))
    tex = rt.Checker(1.1, inner, rt.Noise(3.0))
    # floor at y=0.513 keeps hit points off checker cell boundaries
    return rt.Scene(objects=[
        rt.Quad((-8, 0.513, -8), (16, 0, 0), (0, 0, 16), rt.Lambertian(tex)),
        rt.Sphere((0, 1.5, 0), 1.0, rt.Lambertian(tex))],
        camera=_cam(width, lookfrom=(0, 2, 6), lookat=(0, 1, 0),
                    sky_gradient=True), name="nested_checker")


def medium_box_group(width=24):
    """A constant medium bounded by a Group of two boxes (12 quads) and a
    second medium with a plain box (ragged boundary rows)."""
    white = rt.Lambertian(rt.SolidColor((1, 1, 1)))
    fog = rt.ConstantMedium(
        rt.Group([rt.Box((-2, 0, -2), (2, 2, 2), white),
                  rt.Box((-1, 2, -1), (1, 3, 1), white)]),
        0.4, rt.SolidColor((0.8, 0.7, 0.6)))
    fog2 = rt.ConstantMedium(rt.Box((3, 0, -1), (5, 4, 1), white),
                             0.2, rt.SolidColor((0.3, 0.4, 0.9)))
    return rt.Scene(objects=[
        rt.Quad((-8, 0, -8), (16, 0, 0), (0, 0, 16),
                rt.Lambertian(rt.SolidColor((0.5, 0.5, 0.5)))),
        fog, fog2], camera=_cam(width, lookfrom=(0, 2, 9), lookat=(0, 1, 0),
                                sky_gradient=True), name="medium_box_group")


def medium_two_spheres(width=24):
    """A constant medium bounded by the union of two spheres."""
    white = rt.Lambertian(rt.SolidColor((1, 1, 1)))
    fog = rt.ConstantMedium(
        rt.Group([rt.Sphere((-1.2, 1, 0), 1.5, white),
                  rt.Sphere((1.2, 1, 0), 1.5, white)]),
        0.5, rt.SolidColor((0.9, 0.6, 0.3)))
    return rt.Scene(objects=[
        rt.Quad((-8, 0, -8), (16, 0, 0), (0, 0, 16),
                rt.Lambertian(rt.SolidColor((0.5, 0.5, 0.5)))),
        fog], camera=_cam(width, lookfrom=(0, 1.5, 8), lookat=(0, 1, 0),
                          sky_gradient=True), name="medium_two_spheres")


def many_lights(width=24):
    """Nine quad emitters, all MIS lights."""
    objs = [rt.Quad((i * 3 - 12, 8, 0), (1, 0, 0), (0, 0, 1),
                    rt.DiffuseLight(rt.SolidColor((4, 4, 4))))
            for i in range(9)]
    objs.append(rt.Sphere((0, 1, 0), 1.0,
                          rt.Lambertian(rt.SolidColor((0.5, 0.5, 0.5)))))
    objs.append(rt.Quad((-20, 0, -20), (40, 0, 0), (0, 0, 40),
                        rt.Lambertian(rt.SolidColor((0.6, 0.6, 0.6)))))
    return rt.Scene(objects=objs, lights=objs[:9],
                    camera=_cam(width, lookfrom=(0, 3, 12), lookat=(0, 2, 0),
                                background=(0.05, 0.05, 0.08)),
                    name="many_lights")


def vquad_city(width=24):
    """90 random quads + 40 spheres (one metal in six) + a light sphere."""
    rng = np.random.default_rng(17)
    objs = []
    for _ in range(90):
        c = rng.uniform(-5.0, 5.0, 3)
        u = rng.uniform(0.4, 1.2, 3) * np.array([1.0, 0.0, 1.0])
        v = rng.uniform(0.4, 1.2, 3) * np.array([0.0, 1.0, 1.0])
        albedo = tuple(map(float, rng.uniform(0.2, 0.9, 3)))
        objs.append(rt.Quad(tuple(map(float, c)), tuple(map(float, u)),
                            tuple(map(float, v)),
                            rt.Lambertian(rt.SolidColor(albedo))))
    for i in range(40):
        c = tuple(map(float, rng.uniform(-5, 5, 3)))
        albedo = tuple(map(float, rng.uniform(0.2, 0.9, 3)))
        m = (rt.Metal(albedo, fuzz=0.3) if i % 6 == 0
             else rt.Lambertian(rt.SolidColor(albedo)))
        objs.append(rt.Sphere(c, 0.4, m))
    light = _light_sphere(y=9.0, e=5.0)
    objs.append(light)
    return rt.Scene(objects=objs, lights=[light],
                    camera=_cam(width, vfov=50, lookfrom=(0, 2, 12),
                                lookat=(0, 0, 0), background=(0.4, 0.5, 0.7)),
                    name="vquad_city")


def bouncing(width=24):
    """bouncing_spheres: 485 prims, movers, every material (main.cpp)."""
    s = builders.bouncing_spheres(image_width=width)
    s.camera.samples_per_pixel = 4
    s.camera.max_depth = 4
    return s


def cornell_smoke(width=24):
    s = builders.cornell_smoke()
    s.camera.image_width = width
    s.camera.samples_per_pixel = 4
    s.camera.max_depth = 4
    return s


def multichunk(width=24):
    """300 spheres, every eleventh moving, plus a light sphere."""
    rng = np.random.default_rng(3)
    objs = []
    for i in range(300):
        c = tuple(map(float, rng.uniform(-6, 6, 3)))
        albedo = tuple(map(float, rng.uniform(0.2, 0.9, 3)))
        c2 = (c[0], c[1] + 0.3, c[2]) if i % 11 == 0 else None
        objs.append(rt.Sphere(c, 0.35, rt.Lambertian(rt.SolidColor(albedo)),
                              center2=c2))
    light = _light_sphere(y=10.0, e=5.0)
    objs.append(light)
    return rt.Scene(objects=objs, lights=[light],
                    camera=_cam(width, vfov=40, lookfrom=(0, 2, 14),
                                lookat=(0, 0, 0), background=(0.5, 0.6, 0.8)),
                    name="multichunk")


STRUCTURE_SCENES = {f.__name__: f for f in (
    noise, materials, nested_checker, medium_box_group, medium_two_spheres,
    many_lights, vquad_city, bouncing, cornell_smoke, multichunk)}


# ------------------------------------------------------- gradient scenes
def cornell(width=16):
    s = builders.cornell_box()
    s.camera.image_width = width
    s.camera.samples_per_pixel = 4
    s.camera.max_depth = 4
    return s


def all_families(width=20):
    """Quads + lambertian/metal/glass spheres, the glass sphere doubling as
    a sphere MIS light: every trainable family has signal."""
    glass_sphere = rt.Sphere((0, 1, 1.8), 0.8, rt.Dielectric(1.5))
    return rt.Scene(objects=[
        rt.Quad((-6, 0, -6), (12, 0, 0), (0, 0, 12),
                rt.Lambertian(rt.SolidColor((0.6, 0.5, 0.4)))),
        rt.Quad((-1.5, 5, -1.5), (3, 0, 0), (0, 0, 3),
                rt.DiffuseLight(rt.SolidColor((6, 6, 6)))),
        rt.Sphere((-1.6, 1, 0), 1.0,
                  rt.Lambertian(rt.SolidColor((0.8, 0.2, 0.2)))),
        rt.Sphere((1.6, 1, 0), 1.0, rt.Metal((0.9, 0.9, 0.9), 0.3)),
        glass_sphere,
    ], lights=[rt.Quad((-1.5, 5, -1.5), (3, 0, 0), (0, 0, 3),
                       rt.Lambertian(rt.SolidColor((1, 1, 1)))),
               glass_sphere],
        camera=_cam(width, vfov=40, lookfrom=(0, 2, 9), lookat=(0, 1, 0)),
        name="all_families")


def spheres80(width=16):
    """80 spheres over four materials (one checker, one metal), quad light."""
    rng = np.random.default_rng(2)
    mats = [rt.Lambertian(rt.SolidColor((.8, .3, .2))),
            rt.Lambertian(rt.SolidColor((.2, .7, .4))),
            rt.Lambertian(rt.Checker(0.8, rt.SolidColor((.9, .9, .1)),
                                     rt.SolidColor((.1, .1, .8)))),
            rt.Metal((.9, .8, .7), 0.2)]
    objs = [rt.Sphere(tuple(map(float, rng.uniform(-4, 4, 3))), 0.35,
                      mats[i % len(mats)]) for i in range(80)]
    objs.append(rt.Quad((-6, -6, -7), (12, 0, 0), (0, 12, 0),
                        rt.DiffuseLight(rt.SolidColor((4., 4., 4.)))))
    return rt.Scene(objects=objs, lights=[],
                    camera=_cam(width, vfov=60, lookfrom=(0, 0, 9),
                                lookat=(0, 0, 0),
                                background=(0.2, 0.25, 0.3)),
                    name="spheres80")


def spheres40_textures(width=24):
    """40 spheres with 41 distinct textures (one metal in five)."""
    rng = np.random.default_rng(5)
    objs = []
    for i in range(40):
        c = tuple(map(float, rng.uniform(-4, 4, 3)))
        albedo = tuple(map(float, rng.uniform(0.2, 0.9, 3)))
        m = (rt.Metal(albedo, fuzz=0.2) if i % 5 == 0
             else rt.Lambertian(rt.SolidColor(albedo)))
        objs.append(rt.Sphere(c, 0.5, m))
    light = _light_sphere()
    objs.append(light)
    return rt.Scene(objects=objs, lights=[light],
                    camera=_cam(width, vfov=45, lookfrom=(0, 2, 11),
                                lookat=(0, 0, 0), background=(0.3, 0.4, 0.6)),
                    name="spheres40_textures")


def spheres78_families(width=24):
    """78 spheres: metals, one glass, lambertians, and a light sphere."""
    rng = np.random.default_rng(21)
    objs = []
    for i in range(78):
        c = tuple(map(float, rng.uniform(-4, 4, 3)))
        albedo = tuple(map(float, rng.uniform(0.25, 0.9, 3)))
        m = (rt.Metal(albedo, fuzz=0.25) if i % 9 == 0 else
             rt.Dielectric(1.5) if i == 4 else
             rt.Lambertian(rt.SolidColor(albedo)))
        objs.append(rt.Sphere(c, 0.5, m))
    light = _light_sphere()
    objs.append(light)
    return rt.Scene(objects=objs, lights=[light],
                    camera=_cam(width, vfov=45, lookfrom=(0, 2, 11),
                                lookat=(0, 0, 0), background=(0.3, 0.4, 0.6)),
                    name="spheres78_families")


def spheres78_lambertian(width=16):
    """78 lambertian spheres and a light sphere: many geometry slots."""
    rng = np.random.default_rng(33)
    objs = [rt.Sphere(tuple(map(float, rng.uniform(-4, 4, 3))), 0.5,
                      rt.Lambertian(rt.SolidColor(
                          tuple(map(float, rng.uniform(0.25, 0.9, 3))))))
            for _ in range(78)]
    light = _light_sphere()
    objs.append(light)
    return rt.Scene(objects=objs, lights=[light],
                    camera=_cam(width, max_depth=3, vfov=45,
                                lookfrom=(0, 2, 11), lookat=(0, 0, 0),
                                background=(0.3, 0.4, 0.6)),
                    name="spheres78_lambertian")


def mixed_bvh(width=24):
    """36 spheres + 30 quads (mixed BVH leaves), 41 textures."""
    rng = np.random.default_rng(6)
    objs = [rt.Sphere(tuple(map(float, rng.uniform(-4, 4, 3))), 0.5,
                      rt.Lambertian(rt.SolidColor(
                          tuple(map(float, rng.uniform(0.2, 0.9, 3))))))
            for _ in range(36)]
    for _ in range(30):
        c = rng.uniform(-4.0, 4.0, 3)
        u = rng.uniform(0.4, 1.0, 3) * np.array([1.0, 0.0, 1.0])
        v = rng.uniform(0.4, 1.0, 3) * np.array([0.0, 1.0, 1.0])
        albedo = tuple(map(float, rng.uniform(0.2, 0.9, 3)))
        objs.append(rt.Quad(tuple(map(float, c)), tuple(map(float, u)),
                            tuple(map(float, v)),
                            rt.Lambertian(rt.SolidColor(albedo))))
    light = _light_sphere()
    objs.append(light)
    return rt.Scene(objects=objs, lights=[light],
                    camera=_cam(width, vfov=45, lookfrom=(0, 2, 11),
                                lookat=(0, 0, 0), background=(0.3, 0.4, 0.6)),
                    name="mixed_bvh")


def checker_noise(width=12):
    """Checker ground, a Perlin-marble sphere and a solid sphere."""
    checker = rt.Checker(0.6, rt.SolidColor((0.1, 0.8, 0.2)),
                         rt.SolidColor((0.9, 0.1, 0.6)))
    return rt.Scene(objects=[
        rt.Sphere((0, -100.5, 0), 100.0, rt.Lambertian(checker)),
        rt.Sphere((-1.1, 0.5, 0), 0.5, rt.Lambertian(rt.Noise(2.5))),
        rt.Sphere((1.1, 0.5, 0), 0.5,
                  rt.Lambertian(rt.SolidColor((0.8, 0.6, 0.2))))],
        camera=_cam(width, max_depth=3, vfov=50, lookfrom=(0, 1.2, 4),
                    lookat=(0, 0.4, 0), background=(0.7, 0.8, 1.0)),
        name="checker_noise")


def box_city(width=16):
    """12 boxes (72 quads) on a ground quad, a metal and a matte sphere."""
    rng = np.random.default_rng(3)
    objs = []
    for _ in range(12):
        x, z = rng.uniform(-10, 10, 2)
        hgt = float(rng.uniform(1, 4))
        albedo = tuple(map(float, rng.uniform(0.3, 0.9, 3)))
        objs.append(rt.Box((x, 0, z), (x + 1.5, hgt, z + 1.5),
                           rt.Lambertian(rt.SolidColor(albedo))))
    objs.append(rt.Quad((-20, 0, -20), (40, 0, 0), (0, 0, 40),
                        rt.Lambertian(rt.SolidColor((0.5, 0.5, 0.5)))))
    objs.append(rt.Sphere((0, 2, 3), 1.2, rt.Metal((0.9, 0.8, 0.7), 0.2)))
    objs.append(rt.Sphere((-3, 1.2, 1), 1.0,
                          rt.Lambertian(rt.SolidColor((0.8, 0.3, 0.2)))))
    return rt.Scene(objects=objs, camera=_cam(
        width, vfov=40, lookfrom=(14, 7, 14), lookat=(0, 1, 0),
        sky_gradient=True), name="box_city")
