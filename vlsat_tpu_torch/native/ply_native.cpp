// Native host-side data-loader core of vlsat_tpu_torch (a copy of
// vlsat_tpu/native/ply_native.cpp; host code, no device work).
//
// The reference's input path re-parses each scan's PLY with trimesh on
// every __getitem__ (src/dataset/dataset_3dssg.py:146) — its dominant
// host cost.  This module provides the two hot host loops as a small C
// library (loaded via ctypes, NumPy fallback in data/dataset.py):
//
//   * vlsat_read_ply: binary-little-endian PLY vertex parse extracting
//     x/y/z + the objectId/label instance attribute;
//   * vlsat_prepare_instances: per-instance sampling with replacement +
//     the 11-dim descriptor (centroid, ddof-1 std, bbox dims, volume,
//     max length on RAW samples) + zero-meaned points — the inner loop of
//     dataset preparation (dataset_3dssg.py:279-294).
//
// RNG is a seeded xorshift64*; the sampling distribution matches the
// reference semantics (uniform with replacement) but not NumPy's exact
// stream (documented divergence; sampling is data augmentation).

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Prop {
  std::string name;
  int size;     // bytes
  char kind;    // 'f' float, 'i' int, 'u' uint
};

int type_info(const std::string& t, Prop* p) {
  if (t == "float" || t == "float32") { p->size = 4; p->kind = 'f'; return 0; }
  if (t == "double" || t == "float64") { p->size = 8; p->kind = 'f'; return 0; }
  if (t == "char" || t == "int8") { p->size = 1; p->kind = 'i'; return 0; }
  if (t == "uchar" || t == "uint8") { p->size = 1; p->kind = 'u'; return 0; }
  if (t == "short" || t == "int16") { p->size = 2; p->kind = 'i'; return 0; }
  if (t == "ushort" || t == "uint16") { p->size = 2; p->kind = 'u'; return 0; }
  if (t == "int" || t == "int32") { p->size = 4; p->kind = 'i'; return 0; }
  if (t == "uint" || t == "uint32") { p->size = 4; p->kind = 'u'; return 0; }
  return -1;
}

double read_scalar(const unsigned char* p, const Prop& prop) {
  switch (prop.kind) {
    case 'f':
      if (prop.size == 4) { float v; memcpy(&v, p, 4); return v; }
      else { double v; memcpy(&v, p, 8); return v; }
    case 'i':
      if (prop.size == 1) { int8_t v; memcpy(&v, p, 1); return v; }
      else if (prop.size == 2) { int16_t v; memcpy(&v, p, 2); return v; }
      else { int32_t v; memcpy(&v, p, 4); return v; }
    default:
      if (prop.size == 1) { uint8_t v; memcpy(&v, p, 1); return v; }
      else if (prop.size == 2) { uint16_t v; memcpy(&v, p, 2); return v; }
      else { uint32_t v; memcpy(&v, p, 4); return v; }
  }
}

struct Rng {
  uint64_t s;
  explicit Rng(uint64_t seed) : s(seed ? seed : 0x9e3779b97f4a7c15ULL) {}
  uint64_t next() {
    s ^= s >> 12;
    s ^= s << 25;
    s ^= s >> 27;
    return s * 0x2545F4914F6CDD1DULL;
  }
  // unbiased bounded draw
  uint64_t bounded(uint64_t n) {
    uint64_t threshold = (-n) % n;
    for (;;) {
      uint64_t r = next();
      if (r >= threshold) return r % n;
    }
  }
};

}  // namespace

extern "C" {

// Returns 0 on success.  Caller frees with vlsat_free.
int vlsat_read_ply(const char* path, float** out_pts, int32_t** out_inst,
                   int64_t* out_n) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  char line[4096];
  bool binary_le = false;
  int64_t count = -1;
  std::vector<Prop> props;
  bool in_vertex = false;
  bool header_done = false;
  // Only the leading vertex element is supported (3RScan label meshes).
  while (fgets(line, sizeof(line), f)) {
    std::string s(line);
    while (!s.empty() && (s.back() == '\n' || s.back() == '\r')) s.pop_back();
    if (s == "end_header") { header_done = true; break; }
    if (s.rfind("format ", 0) == 0) {
      binary_le = s.find("binary_little_endian") != std::string::npos;
      if (!binary_le && s.find("ascii") == std::string::npos) { fclose(f); return -2; }
    } else if (s.rfind("element ", 0) == 0) {
      char name[256];
      long long n;
      if (sscanf(s.c_str(), "element %255s %lld", name, &n) == 2) {
        in_vertex = std::string(name) == "vertex";
        if (in_vertex) count = n;
        else if (count >= 0) in_vertex = false;  // later elements ignored
      }
    } else if (in_vertex && s.rfind("property ", 0) == 0) {
      char type[64], name[256];
      if (sscanf(s.c_str(), "property %63s %255s", type, name) == 2) {
        if (std::string(type) == "list") { fclose(f); return -3; }
        Prop p;
        p.name = name;
        if (type_info(type, &p) != 0) { fclose(f); return -4; }
        props.push_back(p);
      }
    }
  }
  if (!header_done || count < 0 || !binary_le) { fclose(f); return -5; }

  int stride = 0;
  int off_x = -1, off_y = -1, off_z = -1, off_inst = -1;
  Prop px, py, pz, pinst;
  for (const auto& p : props) {
    if (p.name == "x") { off_x = stride; px = p; }
    if (p.name == "y") { off_y = stride; py = p; }
    if (p.name == "z") { off_z = stride; pz = p; }
    if (p.name == "objectId" || (off_inst < 0 && p.name == "label")) {
      off_inst = stride;
      pinst = p;
    }
    stride += p.size;
  }
  if (off_x < 0 || off_y < 0 || off_z < 0) { fclose(f); return -6; }

  std::vector<unsigned char> buf((size_t)count * stride);
  if (fread(buf.data(), 1, buf.size(), f) != buf.size()) { fclose(f); return -7; }
  fclose(f);

  float* pts = (float*)malloc(sizeof(float) * 3 * count);
  int32_t* inst = (int32_t*)malloc(sizeof(int32_t) * count);
  for (int64_t i = 0; i < count; ++i) {
    const unsigned char* row = buf.data() + (size_t)i * stride;
    pts[3 * i + 0] = (float)read_scalar(row + off_x, px);
    pts[3 * i + 1] = (float)read_scalar(row + off_y, py);
    pts[3 * i + 2] = (float)read_scalar(row + off_z, pz);
    inst[i] = off_inst >= 0 ? (int32_t)read_scalar(row + off_inst, pinst) : 0;
  }
  *out_pts = pts;
  *out_inst = inst;
  *out_n = count;
  return 0;
}

void vlsat_free(void* p) { free(p); }

// Sample `num_points` points with replacement per node instance, emit the
// 11-dim raw-point descriptor and zero-meaned samples.  Returns 0 on
// success, -1 if a node id has no points.
int vlsat_prepare_instances(const float* pts, const int32_t* inst, int64_t v,
                            const int32_t* node_ids, int32_t n_nodes,
                            int32_t num_points, uint64_t seed,
                            float* out_points,  // n_nodes*num_points*3
                            float* out_desc) {  // n_nodes*11
  // bucket vertex indices by instance id
  for (int32_t n = 0; n < n_nodes; ++n) {
    int32_t id = node_ids[n];
    std::vector<int64_t> sel;
    sel.reserve(1024);
    for (int64_t i = 0; i < v; ++i)
      if (inst[i] == id) sel.push_back(i);
    if (sel.empty()) return -1;

    Rng rng(seed + (uint64_t)id * 0x9E3779B97F4A7C15ULL + n);
    float* op = out_points + (size_t)n * num_points * 3;
    double mean[3] = {0, 0, 0};
    float mn[3] = {1e30f, 1e30f, 1e30f}, mx[3] = {-1e30f, -1e30f, -1e30f};
    for (int32_t k = 0; k < num_points; ++k) {
      int64_t j = sel[rng.bounded(sel.size())];
      for (int d = 0; d < 3; ++d) {
        float val = pts[3 * j + d];
        op[3 * k + d] = val;
        mean[d] += val;
        if (val < mn[d]) mn[d] = val;
        if (val > mx[d]) mx[d] = val;
      }
    }
    for (int d = 0; d < 3; ++d) mean[d] /= num_points;
    double var[3] = {0, 0, 0};
    for (int32_t k = 0; k < num_points; ++k)
      for (int d = 0; d < 3; ++d) {
        double c = op[3 * k + d] - mean[d];
        var[d] += c * c;
      }
    float* dd = out_desc + (size_t)n * 11;
    float dims[3];
    for (int d = 0; d < 3; ++d) {
      dd[d] = (float)mean[d];
      dd[3 + d] = (float)std::sqrt(var[d] / (num_points - 1));  // ddof=1
      dims[d] = mx[d] - mn[d];
      dd[6 + d] = dims[d];
    }
    dd[9] = dims[0] * dims[1] * dims[2];
    dd[10] = std::fmax(dims[0], std::fmax(dims[1], dims[2]));
    // zero-mean the samples (after the descriptor, reference order)
    for (int32_t k = 0; k < num_points; ++k)
      for (int d = 0; d < 3; ++d) op[3 * k + d] -= (float)mean[d];
  }
  return 0;
}

}  // extern "C"
