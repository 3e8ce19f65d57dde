// Validation driver for the REFERENCE renderer (prabhask5/
// real-time-ray-tracing-engine, mounted read-only at /root/reference).
//
// Purpose: produce ground-truth PPM renders of this repo's JSON scenes
// (real_time_ray_tracing_engine_tpu/scene/schema.py format) using the
// reference's own CPU path — StaticCamera::render_cpu -> Camera::ray_color
// (reference src/core/camera/StaticCamera.cpp:32-131, Camera.cpp:232-309) —
// so tests/test_reference_images.py can compare the JAX engine against the
// actual reference implementation rather than a self-written oracle.
//
// This file contains NO copied reference code: it links against the
// unmodified reference translation units (see scripts/build_reference.sh)
// and only constructs reference scene objects through their public
// constructors, the same way the reference's own main.cpp scene builders do
// (src/main.cpp:21-131).
//
// Usage: ref_driver <scene.json> <output_name_without_ext>
//            [--parallel] [--bvh] [--width N] [--samples N] [--depth N]
// Writes output/<output_name>.ppm under the current working directory.

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fstream>
#include <iostream>
#include <map>
#include <memory>
#include <sstream>
#include <string>
#include <vector>

#include "core/HittableList.hpp"
#include "core/camera/CameraConfig.hpp"
#include "core/camera/StaticCamera.hpp"
#include "scene/materials/DielectricMaterial.hpp"
#include "scene/materials/DiffuseLightMaterial.hpp"
#include "scene/materials/IsotropicMaterial.hpp"
#include "scene/materials/LambertianMaterial.hpp"
#include "scene/materials/MetalMaterial.hpp"
#include "scene/mediums/ConstantMedium.hpp"
#include "scene/objects/Plane.hpp"
#include "scene/objects/PlaneUtility.hpp"
#include "scene/objects/RotateY.hpp"
#include "scene/objects/Sphere.hpp"
#include "scene/objects/Translate.hpp"
#include "scene/textures/CheckerTexture.hpp"
#include "scene/textures/NoiseTexture.hpp"
#include "scene/textures/SolidColorTexture.hpp"

// ------------------------------------------------------------ tiny JSON
// Minimal recursive-descent JSON parser — just enough for the repo's scene
// schema (objects / arrays / strings / numbers / bools / null).
struct JValue {
  enum Kind { OBJ, ARR, STR, NUM, BOOL, NUL } kind = NUL;
  std::map<std::string, JValue> obj;
  std::vector<JValue> arr;
  std::string str;
  double num = 0.0;
  bool b = false;

  bool has(const std::string &k) const { return obj.count(k) > 0; }
  const JValue &operator[](const std::string &k) const { return obj.at(k); }
  double d(const std::string &k, double dflt) const {
    return has(k) && obj.at(k).kind == NUM ? obj.at(k).num : dflt;
  }
};

struct JParser {
  const char *p;
  explicit JParser(const char *text) : p(text) {}
  void ws() {
    while (*p == ' ' || *p == '\n' || *p == '\t' || *p == '\r') ++p;
  }
  JValue parse() {
    ws();
    JValue v;
    if (*p == '{') {
      v.kind = JValue::OBJ;
      ++p;
      ws();
      if (*p == '}') { ++p; return v; }
      while (true) {
        ws();
        JValue key = parse_string();
        ws();
        if (*p++ != ':') abort_at("expected ':'");
        v.obj[key.str] = parse();
        ws();
        if (*p == ',') { ++p; continue; }
        if (*p == '}') { ++p; break; }
        abort_at("expected ',' or '}'");
      }
    } else if (*p == '[') {
      v.kind = JValue::ARR;
      ++p;
      ws();
      if (*p == ']') { ++p; return v; }
      while (true) {
        v.arr.push_back(parse());
        ws();
        if (*p == ',') { ++p; continue; }
        if (*p == ']') { ++p; break; }
        abort_at("expected ',' or ']'");
      }
    } else if (*p == '"') {
      v = parse_string();
    } else if (!strncmp(p, "true", 4)) {
      v.kind = JValue::BOOL; v.b = true; p += 4;
    } else if (!strncmp(p, "false", 5)) {
      v.kind = JValue::BOOL; v.b = false; p += 5;
    } else if (!strncmp(p, "null", 4)) {
      v.kind = JValue::NUL; p += 4;
    } else {
      v.kind = JValue::NUM;
      char *end = nullptr;
      v.num = strtod(p, &end);
      if (end == p) abort_at("bad number");
      p = end;
    }
    return v;
  }
  JValue parse_string() {
    JValue v;
    v.kind = JValue::STR;
    if (*p++ != '"') abort_at("expected '\"'");
    while (*p && *p != '"') {
      if (*p == '\\') ++p;
      v.str += *p++;
    }
    ++p;
    return v;
  }
  void abort_at(const char *msg) {
    std::cerr << "[ref_driver] JSON parse error: " << msg << " near '"
              << std::string(p).substr(0, 40) << "'\n";
    std::exit(2);
  }
};

// ------------------------------------------------------- schema -> objects
static Vec3 to_vec(const JValue &a) {
  return Vec3(a.arr.at(0).num, a.arr.at(1).num, a.arr.at(2).num);
}

static TexturePtr make_texture(const JValue &t) {
  const std::string &kind = t["kind"].str;
  if (kind == "solid")
    return std::make_shared<SolidColorTexture>(to_vec(t["albedo"]));
  if (kind == "checker")
    return std::make_shared<CheckerTexture>(
        t["scale"].num, make_texture(t["even"]), make_texture(t["odd"]));
  if (kind == "noise")
    return std::make_shared<NoiseTexture>(t["scale"].num);
  std::cerr << "[ref_driver] unknown texture kind " << kind << "\n";
  std::exit(2);
}

static MaterialPtr make_material(const JValue &m) {
  const std::string &kind = m["kind"].str;
  if (kind == "lambertian")
    return std::make_shared<LambertianMaterial>(make_texture(m["texture"]));
  if (kind == "metal")
    return std::make_shared<MetalMaterial>(to_vec(m["albedo"]),
                                           m.d("fuzz", 0.0));
  if (kind == "dielectric")
    return std::make_shared<DielectricMaterial>(m["refraction_index"].num);
  if (kind == "diffuse_light")
    return std::make_shared<DiffuseLightMaterial>(make_texture(m["texture"]));
  if (kind == "isotropic")
    return std::make_shared<IsotropicMaterial>(make_texture(m["texture"]));
  std::cerr << "[ref_driver] unknown material kind " << kind << "\n";
  std::exit(2);
}

// empty_mat=true builds light-list geometry with a null material, exactly as
// the reference's own scene builders do (src/main.cpp:57-66).
static HittablePtr make_object(const JValue &o, bool empty_mat) {
  const std::string &kind = o["kind"].str;
  MaterialPtr mat;
  if (!empty_mat && o.has("material")) mat = make_material(o["material"]);
  if (kind == "sphere") {
    Point3 c = to_vec(o["center"]);
    double r = o["radius"].num;
    if (o.has("center2") && o["center2"].kind == JValue::ARR)
      return std::make_shared<Sphere>(c, to_vec(o["center2"]), r, mat);
    return std::make_shared<Sphere>(c, r, mat);
  }
  if (kind == "quad")
    return std::make_shared<Plane>(to_vec(o["corner"]), to_vec(o["u"]),
                                   to_vec(o["v"]), mat);
  if (kind == "box")
    return make_box(to_vec(o["a"]), to_vec(o["b"]), mat);
  if (kind == "translate")
    return std::make_shared<Translate>(make_object(o["child"], empty_mat),
                                       to_vec(o["offset"]));
  if (kind == "rotate_y")
    return std::make_shared<RotateY>(make_object(o["child"], empty_mat),
                                     o["angle_degrees"].num);
  if (kind == "constant_medium")
    return std::make_shared<ConstantMedium>(
        make_object(o["boundary"], /*empty_mat=*/true), o["density"].num,
        make_texture(o["texture"]));
  std::cerr << "[ref_driver] unknown object kind " << kind << "\n";
  std::exit(2);
}

int main(int argc, char **argv) {
  if (argc < 3) {
    std::cerr << "usage: ref_driver <scene.json> <output_name> [--parallel] "
                 "[--bvh] [--width N] [--samples N] [--depth N]\n";
    return 1;
  }
  std::ifstream f(argv[1]);
  if (!f) {
    std::cerr << "[ref_driver] cannot open " << argv[1] << "\n";
    return 1;
  }
  std::stringstream ss;
  ss << f.rdbuf();
  std::string text = ss.str();
  JParser parser(text.c_str());
  JValue root = parser.parse();

  const JValue &cam = root["camera"];
  CameraConfig cfg;
  cfg.image_width = (int)cam.d("image_width", 600);
  cfg.samples_per_pixel = (int)cam.d("samples_per_pixel", 100);
  cfg.max_depth = (int)cam.d("max_depth", 50);
  cfg.aspect_ratio = cam.d("aspect_ratio", 1.0);
  cfg.vfov = cam.d("vfov", 40.0);
  cfg.defocus_angle = cam.d("defocus_angle", 0.0);
  cfg.focus_dist = cam.d("focus_dist", 10.0);
  cfg.lookfrom = to_vec(cam["lookfrom"]);
  cfg.lookat = to_vec(cam["lookat"]);
  cfg.vup = to_vec(cam["vup"]);
  cfg.background = to_vec(cam["background"]);
  if (cam.has("sky_gradient") && cam["sky_gradient"].b) {
    std::cerr << "[ref_driver] NOTE: reference has no sky-gradient "
                 "background (Camera.cpp:242-243 uses a constant color); "
                 "render this scene with a solid background variant.\n";
  }

  for (int i = 3; i < argc; ++i) {
    std::string a = argv[i];
    if (a == "--parallel") cfg.use_parallelism = true;
    else if (a == "--bvh") cfg.use_bvh = true;
    else if (a == "--width" && i + 1 < argc) cfg.image_width = atoi(argv[++i]);
    else if (a == "--samples" && i + 1 < argc)
      cfg.samples_per_pixel = atoi(argv[++i]);
    else if (a == "--depth" && i + 1 < argc) cfg.max_depth = atoi(argv[++i]);
  }

  HittableList world, lights;
  for (const JValue &o : root["objects"].arr)
    world.add(make_object(o, /*empty_mat=*/false));
  if (root.has("lights"))
    for (const JValue &o : root["lights"].arr)
      lights.add(make_object(o, /*empty_mat=*/true));

  std::string out_name = std::string(argv[2]) + ".ppm";
  StaticCamera camera(cfg, out_name);
  camera.render(world, lights);
  std::cerr << "[ref_driver] wrote output/" << out_name << "\n";
  return 0;
}
