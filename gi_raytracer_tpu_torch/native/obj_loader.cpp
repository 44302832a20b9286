// Native OBJ reader: v/vt/vn + triangulated faces (v, v//n, v/t, v/t/n),
// matching gi_raytracer_tpu_torch/scene/objio.py (itself covering the
// reference's subset, reference include/meshLoader.cpp:54-93).  The port's
// own copy of gi_raytracer_tpu/native/obj_loader.cpp.  Single pass with
// growable buffers; rotation/translation are applied Python-side.
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct Mesh {
  std::vector<float> v, vt, vn;
  std::vector<int32_t> fv, ft, fn;  // per corner; 0 = absent (1-based else)
};

bool parse(const char* path, Mesh& m) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  char line[4096];
  while (std::fgets(line, sizeof line, f)) {
    if (line[0] == 'v' && line[1] == ' ') {
      float x, y, z;
      if (std::sscanf(line + 2, "%f %f %f", &x, &y, &z) == 3) {
        m.v.push_back(x); m.v.push_back(y); m.v.push_back(z);
      }
    } else if (line[0] == 'v' && line[1] == 't') {
      float u2, v2;
      if (std::sscanf(line + 3, "%f %f", &u2, &v2) == 2) {
        m.vt.push_back(u2); m.vt.push_back(v2);
      }
    } else if (line[0] == 'v' && line[1] == 'n') {
      float x, y, z;
      if (std::sscanf(line + 3, "%f %f %f", &x, &y, &z) == 3) {
        m.vn.push_back(x); m.vn.push_back(y); m.vn.push_back(z);
      }
    } else if (line[0] == 'f' && line[1] == ' ') {
      int32_t vi[64], ti[64], ni[64];
      int k = 0;
      const char* p = line + 2;
      while (*p && k < 64) {
        while (*p == ' ' || *p == '\t') ++p;
        if (*p == '\n' || *p == '\r' || *p == 0) break;
        char* end;
        long a = std::strtol(p, &end, 10);
        if (end == p) break;
        p = end;
        long b = 0, c = 0;
        if (*p == '/') {
          ++p;
          if (*p != '/') { b = std::strtol(p, &end, 10); p = end; }
          if (*p == '/') { ++p; c = std::strtol(p, &end, 10); p = end; }
        }
        vi[k] = (int32_t)a; ti[k] = (int32_t)b; ni[k] = (int32_t)c;
        ++k;
      }
      for (int i = 1; i + 1 < k; ++i) {  // fan triangulation
        int corners[3] = {0, i, i + 1};
        for (int cidx : corners) {
          m.fv.push_back(vi[cidx]);
          m.ft.push_back(ti[cidx]);
          m.fn.push_back(ni[cidx]);
        }
      }
    }
  }
  std::fclose(f);
  return true;
}

Mesh* g_last = nullptr;

}  // namespace

extern "C" {

// Parses; returns counts via out params.  Buffers fetched with gi_obj_get_*
// then released with gi_obj_free.
int32_t gi_obj_parse(const char* path, int32_t* n_v, int32_t* n_vt,
                     int32_t* n_vn, int32_t* n_corners) {
  Mesh* m = new Mesh();
  if (!parse(path, *m)) { delete m; return -1; }
  delete g_last;
  g_last = m;
  *n_v = (int32_t)(m->v.size() / 3);
  *n_vt = (int32_t)(m->vt.size() / 2);
  *n_vn = (int32_t)(m->vn.size() / 3);
  *n_corners = (int32_t)m->fv.size();
  return 0;
}

void gi_obj_fetch(float* v, float* vt, float* vn, int32_t* fv, int32_t* ft,
                  int32_t* fn) {
  if (!g_last) return;
  std::memcpy(v, g_last->v.data(), g_last->v.size() * sizeof(float));
  std::memcpy(vt, g_last->vt.data(), g_last->vt.size() * sizeof(float));
  std::memcpy(vn, g_last->vn.data(), g_last->vn.size() * sizeof(float));
  std::memcpy(fv, g_last->fv.data(), g_last->fv.size() * sizeof(int32_t));
  std::memcpy(ft, g_last->ft.data(), g_last->ft.size() * sizeof(int32_t));
  std::memcpy(fn, g_last->fn.data(), g_last->fn.size() * sizeof(int32_t));
}

void gi_obj_free() {
  delete g_last;
  g_last = nullptr;
}
}
