// The port's own copy of rgk_tpu/native/obj_loader.cpp, kept equal to it.
// Native OBJ tokenizer: the data-loading hot path for multi-million-
// triangle meshes (the TPU build's replacement for the reference's
// assimp import, reference src/config.cpp loadAssimpScene).
//
// Scope: tokenizing only — v/vt/vn records, fan-triangulated face
// corner triples with 1-based and negative index resolution, usemtl
// group ids and mtllib names.  Vertex unification, normal/tangent
// generation and MTL parsing stay in numpy/python (rgk_tpu_torch/io/obj.py),
// which is vectorized and already fast.
//
// C API (ctypes): rgk_obj_load -> opaque handle; rgk_obj_counts;
// rgk_obj_fill copies into caller-allocated numpy buffers;
// rgk_obj_free.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct ObjData {
  std::vector<float> pos, uv, nrm;
  std::vector<int32_t> corners;  // nf * 9: (v,vt,vn) x 3, -1 = absent
  std::vector<int32_t> group;    // nf
  std::string group_blob;        // group names joined by '\n'
  std::string mtllib_blob;       // mtllib names joined by '\n'
  int32_t n_groups = 0;
};

inline const char* skip_ws(const char* p, const char* end) {
  while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
  return p;
}

inline int32_t fix_index(long v, size_t n) {
  if (v > 0) return static_cast<int32_t>(v - 1);
  if (v == 0) return -1;
  return static_cast<int32_t>(static_cast<long>(n) + v);
}

}  // namespace

extern "C" {

void* rgk_obj_load(const char* path) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::string buf(static_cast<size_t>(size), '\0');
  if (size > 0 && std::fread(&buf[0], 1, size, f) != (size_t)size) {
    std::fclose(f);
    return nullptr;
  }
  std::fclose(f);

  auto* d = new ObjData();
  std::unordered_map<std::string, int32_t> group_ids;
  int32_t cur_group = -1;
  auto ensure_group = [&](const std::string& name) {
    auto it = group_ids.find(name);
    if (it != group_ids.end()) return it->second;
    int32_t id = d->n_groups++;
    group_ids.emplace(name, id);
    // Join by id, not by blob emptiness: the implicit unnamed group
    // ("") must still occupy a blob slot or ids and names misalign.
    if (id > 0) d->group_blob += '\n';
    d->group_blob += name;
    return id;
  };

  const char* p = buf.data();
  const char* end = p + buf.size();
  std::vector<int32_t> face;  // corner scratch: v,vt,vn per corner
  face.reserve(48);

  while (p < end) {
    const char* line_end = static_cast<const char*>(
        memchr(p, '\n', end - p));
    if (!line_end) line_end = end;
    const char* q = skip_ws(p, line_end);

    if (q + 1 < line_end && q[0] == 'v' &&
        (q[1] == ' ' || q[1] == '\t')) {
      char* next = nullptr;
      for (int k = 0; k < 3; ++k) {
        float val = std::strtof(q + (k == 0 ? 1 : 0), &next);
        d->pos.push_back(val);
        q = next;
      }
    } else if (q + 2 < line_end && q[0] == 'v' && q[1] == 't' &&
               (q[2] == ' ' || q[2] == '\t')) {
      char* next = nullptr;
      for (int k = 0; k < 2; ++k) {
        float val = std::strtof(q + (k == 0 ? 2 : 0), &next);
        d->uv.push_back(val);
        q = next;
      }
    } else if (q + 2 < line_end && q[0] == 'v' && q[1] == 'n' &&
               (q[2] == ' ' || q[2] == '\t')) {
      char* next = nullptr;
      for (int k = 0; k < 3; ++k) {
        float val = std::strtof(q + (k == 0 ? 2 : 0), &next);
        d->nrm.push_back(val);
        q = next;
      }
    } else if (q + 1 < line_end && q[0] == 'f' &&
               (q[1] == ' ' || q[1] == '\t')) {
      face.clear();
      const char* t = q + 1;
      size_t nv = d->pos.size() / 3, nt = d->uv.size() / 2,
             nn = d->nrm.size() / 3;
      while (t < line_end) {
        t = skip_ws(t, line_end);
        if (t >= line_end || *t == '#') break;
        char* next = nullptr;
        long v = std::strtol(t, &next, 10);
        if (next == t) break;
        t = next;
        long vt = 0, vn = 0;
        bool has_vt = false, has_vn = false;
        if (t < line_end && *t == '/') {
          ++t;
          if (t < line_end && *t != '/') {
            vt = std::strtol(t, &next, 10);
            has_vt = next != t;
            t = next;
          }
          if (t < line_end && *t == '/') {
            ++t;
            vn = std::strtol(t, &next, 10);
            has_vn = next != t;
            t = next;
          }
        }
        face.push_back(fix_index(v, nv));
        face.push_back(has_vt ? fix_index(vt, nt) : -1);
        face.push_back(has_vn ? fix_index(vn, nn) : -1);
      }
      size_t n_corners = face.size() / 3;
      if (n_corners >= 3) {
        if (cur_group < 0) cur_group = ensure_group("");
        for (size_t i = 1; i + 1 < n_corners; ++i) {  // fan
          for (int c : {0, (int)i, (int)i + 1})
            for (int k = 0; k < 3; ++k)
              d->corners.push_back(face[3 * c + k]);
          d->group.push_back(cur_group);
        }
      }
    } else if (line_end - q > 7 && !std::strncmp(q, "usemtl", 6)) {
      const char* n0 = skip_ws(q + 6, line_end);
      std::string name(n0, line_end - n0);
      while (!name.empty() &&
             (name.back() == '\r' || name.back() == ' '))
        name.pop_back();
      cur_group = ensure_group(name);
    } else if (line_end - q > 7 && !std::strncmp(q, "mtllib", 6)) {
      const char* n0 = skip_ws(q + 6, line_end);
      std::string name(n0, line_end - n0);
      while (!name.empty() &&
             (name.back() == '\r' || name.back() == ' '))
        name.pop_back();
      if (!d->mtllib_blob.empty()) d->mtllib_blob += '\n';
      d->mtllib_blob += name;
    }
    p = line_end + 1;
  }
  return d;
}

// out8: nv, nt, nn, nf, n_groups, group_blob_bytes, mtllib_blob_bytes, 0
void rgk_obj_counts(void* h, int64_t* out8) {
  auto* d = static_cast<ObjData*>(h);
  out8[0] = d->pos.size() / 3;
  out8[1] = d->uv.size() / 2;
  out8[2] = d->nrm.size() / 3;
  out8[3] = d->group.size();
  out8[4] = d->n_groups;
  out8[5] = d->group_blob.size();
  out8[6] = d->mtllib_blob.size();
  out8[7] = 0;
}

void rgk_obj_fill(void* h, float* pos, float* uv, float* nrm,
                  int32_t* corners, int32_t* group, char* group_blob,
                  char* mtllib_blob) {
  auto* d = static_cast<ObjData*>(h);
  std::memcpy(pos, d->pos.data(), d->pos.size() * sizeof(float));
  std::memcpy(uv, d->uv.data(), d->uv.size() * sizeof(float));
  std::memcpy(nrm, d->nrm.data(), d->nrm.size() * sizeof(float));
  std::memcpy(corners, d->corners.data(),
              d->corners.size() * sizeof(int32_t));
  std::memcpy(group, d->group.data(), d->group.size() * sizeof(int32_t));
  std::memcpy(group_blob, d->group_blob.data(), d->group_blob.size());
  std::memcpy(mtllib_blob, d->mtllib_blob.data(), d->mtllib_blob.size());
}

void rgk_obj_free(void* h) { delete static_cast<ObjData*>(h); }

}  // extern "C"
