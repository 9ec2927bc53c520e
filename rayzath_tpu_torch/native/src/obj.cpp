// Native OBJ parser for rayzath_tpu_torch: a copy of the JAX package's
// rayzath_tpu/native/src/obj.cpp, kept identical, behind the port's
// io/obj.py.
//
// Fast data-loader equivalent of the reference OBJ parsing
// (RayZath/loader.cpp:738-1040), with the exact semantics of the Python
// fallback in rayzath_tpu/io/obj.py (which is the tested behavioral spec):
//
//   * `o` / `g` starts a new mesh; vertex and normal z is negated
//     (right-handed .obj -> left-handed engine space),
//   * faces fan-triangulate with winding (0, i+2, i+1), up to 8-gons,
//   * indices may be positive (1-based), negative (relative), or 0 (unused);
//     out-of-range indices resolve to -1 with an error log,
//   * each mesh's component indices are re-based to the min..max range of the
//     global pools it references,
//   * `usemtl` allocates per-mesh material slots, capped at 64,
//   * `mtllib` paths are collected; unrecognized statements warn once.
//
// Parsed results are held in a heap-allocated handle queried through a plain
// C ABI (ctypes-friendly); the Python wrapper converts to Mesh objects.

#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <limits>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

constexpr int NO_INDEX = -1;
constexpr int MATERIAL_CAPACITY = 64;  // reference instance.hpp:17
constexpr int MAX_NGON = 8;

struct MeshOut {
    std::string name;
    std::vector<float> vertices;  // [nv*3]
    std::vector<float> texcrds;   // [nt*2]
    std::vector<float> normals;   // [nn*3]
    std::vector<int32_t> tri_v, tri_t, tri_n;  // [f*3]
    std::vector<int32_t> tri_m;                // [f]
    std::vector<std::string> slot_names;       // slot index -> material name
};

struct LogEntry {
    int level;  // 0=message, 1=warning, 2=error
    std::string text;
};

struct ObjResult {
    std::vector<MeshOut> meshes;
    std::vector<std::string> mtllibs;
    std::vector<LogEntry> log;
};

struct Parser {
    ObjResult* out;
    std::vector<float> vertices, texcrds, normals;  // global pools (*3/*2/*3)
    // current mesh accumulation (global indices, re-based at flush)
    std::vector<int32_t> tri_v, tri_t, tri_n, tri_m;
    std::unordered_map<std::string, int> slots;
    std::vector<std::string> slot_names;
    int material_count = 0;
    int material_idx = 0;
    bool have_mesh = false;
    std::unordered_map<std::string, bool> unrecognized;

    void warn(const std::string& s) { out->log.push_back({1, s}); }
    void error(const std::string& s) { out->log.push_back({2, s}); }

    void flush() {
        if (!have_mesh) return;
        MeshOut& pm = out->meshes.back();
        if (!tri_v.empty()) {
            auto rebase = [](std::vector<int32_t>& tri, int* lo_out, int* hi_out) {
                int lo = std::numeric_limits<int>::max(), hi = 0;
                for (int32_t v : tri)
                    if (v >= 0) {
                        lo = std::min(lo, static_cast<int>(v));
                        hi = std::max(hi, static_cast<int>(v) + 1);
                    }
                if (hi == 0) lo = 0;
                for (int32_t& v : tri) v = (v >= 0) ? v - lo : NO_INDEX;
                *lo_out = lo;
                *hi_out = hi;
            };
            int vlo, vhi, tlo, thi, nlo, nhi;
            rebase(tri_v, &vlo, &vhi);
            rebase(tri_t, &tlo, &thi);
            rebase(tri_n, &nlo, &nhi);
            pm.vertices.assign(vertices.begin() + 3 * vlo, vertices.begin() + 3 * vhi);
            pm.texcrds.assign(texcrds.begin() + 2 * tlo, texcrds.begin() + 2 * thi);
            pm.normals.assign(normals.begin() + 3 * nlo, normals.begin() + 3 * nhi);
            pm.tri_v = std::move(tri_v);
            pm.tri_t = std::move(tri_t);
            pm.tri_n = std::move(tri_n);
            pm.tri_m = std::move(tri_m);
        }
        pm.slot_names = slot_names;
        tri_v.clear(); tri_t.clear(); tri_n.clear(); tri_m.clear();
    }

    int resolve(long idx, size_t pool_len, const char* what, long line_no) {
        const long n = static_cast<long>(pool_len);
        if (idx > 0 && idx <= n) return static_cast<int>(idx - 1);
        if (idx < 0 && -idx <= n) return static_cast<int>(n + idx);
        if (idx != 0)
            error("On line " + std::to_string(line_no) + ": " + what +
                  " index outside of range.");
        return NO_INDEX;
    }
};

// Split a whitespace-trimmed line into (stmt, rest).
void split_stmt(const char* line, std::string* stmt, const char** rest) {
    const char* p = line;
    while (*p && !std::isspace(static_cast<unsigned char>(*p))) ++p;
    stmt->assign(line, p - line);
    while (*p && std::isspace(static_cast<unsigned char>(*p))) ++p;
    *rest = p;
}

// Parse up to `max_n` floats; returns how many were parsed.
int parse_floats(const char* s, float* out, int max_n) {
    int n = 0;
    char* end;
    while (n < max_n) {
        const float v = std::strtof(s, &end);
        if (end == s) break;
        out[n++] = v;
        s = end;
    }
    return n;
}

void parse_line(Parser& P, char* line, long line_no) {
    // trim
    char* s = line;
    while (*s && std::isspace(static_cast<unsigned char>(*s))) ++s;
    char* e = s + std::strlen(s);
    while (e > s && std::isspace(static_cast<unsigned char>(e[-1]))) --e;
    *e = '\0';
    if (!*s || *s == '#') return;

    std::string stmt;
    const char* rest;
    split_stmt(s, &stmt, &rest);

    ObjResult& out = *P.out;
    if (stmt == "mtllib") {
        out.mtllibs.emplace_back(rest);
    } else if (stmt == "v") {
        float f[3];
        if (parse_floats(rest, f, 3) < 3) {
            P.error("Vertex definition on line " + std::to_string(line_no) +
                    " is invalid.");
            return;
        }
        P.vertices.insert(P.vertices.end(), {f[0], f[1], -f[2]});
    } else if (stmt == "vt") {
        float f[2];
        if (parse_floats(rest, f, 2) < 2) {
            P.error("Texcrd definition on line " + std::to_string(line_no) +
                    " is invalid.");
            return;
        }
        P.texcrds.insert(P.texcrds.end(), {f[0], f[1]});
    } else if (stmt == "vn") {
        float f[3];
        if (parse_floats(rest, f, 3) < 3) {
            P.error("Normal definition on line " + std::to_string(line_no) +
                    " is invalid.");
            return;
        }
        f[2] = -f[2];
        const double norm2 = static_cast<double>(f[0]) * f[0] +
                             static_cast<double>(f[1]) * f[1] +
                             static_cast<double>(f[2]) * f[2];
        if (norm2 < 1e-24) {  // |n| < 1e-12
            P.warn("Line " + std::to_string(line_no) + ": normal is invalid.");
            f[0] = 0.f; f[1] = 1.f; f[2] = 0.f;
        }
        P.normals.insert(P.normals.end(), {f[0], f[1], f[2]});
    } else if (stmt == "o" || stmt == "g") {
        P.flush();
        out.meshes.emplace_back();
        out.meshes.back().name = rest;
        P.slots.clear();
        P.slot_names.clear();
        P.material_count = 0;
        P.material_idx = 0;
        P.have_mesh = true;
    } else if (!P.have_mesh) {
        P.warn("Statement in line " + std::to_string(line_no) +
               " has to be preceded by object or group declaration. Ignored.");
    } else if (stmt == "usemtl") {
        const std::string name(rest);
        auto it = P.slots.find(name);
        if (it != P.slots.end()) {
            P.material_idx = it->second;
        } else if (P.material_count >= MATERIAL_CAPACITY) {
            P.warn("usemtl \"" + name + "\" on line " + std::to_string(line_no) +
                   " exceeds " + std::to_string(MATERIAL_CAPACITY) +
                   " materials per object. Ignored.");
        } else {
            P.material_idx = P.material_count;
            P.slots[name] = P.material_count;
            P.slot_names.push_back(name);
            ++P.material_count;
        }
    } else if (stmt == "f") {
        int tv[MAX_NGON], tt[MAX_NGON], tn[MAX_NGON];
        int n = 0;
        const char* p = rest;
        while (*p && n < MAX_NGON) {
            while (*p && std::isspace(static_cast<unsigned char>(*p))) ++p;
            if (!*p) break;
            const char* tok = p;
            while (*p && !std::isspace(static_cast<unsigned char>(*p))) ++p;
            std::string buff(tok, p - tok);
            long ids[3] = {0, 0, 0};
            size_t pos = 0;
            for (int k = 0; k < 3; ++k) {
                size_t slash = buff.find('/', pos);
                std::string part = buff.substr(
                    pos, slash == std::string::npos ? std::string::npos : slash - pos);
                if (!part.empty()) {
                    char* endp;
                    const long val = std::strtol(part.c_str(), &endp, 10);
                    if (*endp != '\0') {
                        P.error("Face on line " + std::to_string(line_no) +
                                ": invalid index.");
                        ids[k] = 0;
                    } else {
                        ids[k] = val;
                    }
                }
                if (slash == std::string::npos) break;
                pos = slash + 1;
            }
            tv[n] = P.resolve(ids[0], P.vertices.size() / 3, "vertex", line_no);
            tt[n] = P.resolve(ids[1], P.texcrds.size() / 2,
                              "texture coordinate", line_no);
            tn[n] = P.resolve(ids[2], P.normals.size() / 3, "normal", line_no);
            ++n;
        }
        if (n < 3) {
            P.error("On line " + std::to_string(line_no) +
                    ": at least three vertex indices required.");
            return;
        }
        // fan triangulation with reference winding (0, i+2, i+1)
        for (int i = 0; i < n - 2; ++i) {
            P.tri_v.insert(P.tri_v.end(), {tv[0], tv[i + 2], tv[i + 1]});
            P.tri_t.insert(P.tri_t.end(), {tt[0], tt[i + 2], tt[i + 1]});
            P.tri_n.insert(P.tri_n.end(), {tn[0], tn[i + 2], tn[i + 1]});
            P.tri_m.push_back(P.material_idx);
        }
    } else {
        if (!P.unrecognized.count(stmt)) {
            P.warn("Unrecognized statement \"" + stmt + "\".");
            P.unrecognized[stmt] = true;
        }
    }
}

}  // namespace

extern "C" {

void* rz_obj_parse(const char* path) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return nullptr;
    auto* out = new ObjResult();
    Parser P;
    P.out = out;

    std::vector<char> buf(1 << 16);
    std::string pending;
    long line_no = 0;
    size_t got;
    while ((got = std::fread(buf.data(), 1, buf.size(), f)) > 0) {
        size_t start = 0;
        for (size_t i = 0; i < got; ++i) {
            if (buf[i] == '\n') {
                pending.append(buf.data() + start, i - start);
                parse_line(P, pending.data(), line_no++);
                pending.clear();
                start = i + 1;
            }
        }
        pending.append(buf.data() + start, got - start);
    }
    if (!pending.empty()) parse_line(P, pending.data(), line_no++);
    std::fclose(f);
    P.flush();
    return out;
}

void rz_obj_free(void* h) { delete static_cast<ObjResult*>(h); }

int rz_obj_mesh_count(void* h) {
    return static_cast<int>(static_cast<ObjResult*>(h)->meshes.size());
}

const char* rz_obj_mesh_name(void* h, int i) {
    return static_cast<ObjResult*>(h)->meshes[i].name.c_str();
}

// counts: [n_vertices, n_texcrds, n_normals, n_triangles, n_slots]
void rz_obj_mesh_counts(void* h, int i, int32_t* counts) {
    const MeshOut& m = static_cast<ObjResult*>(h)->meshes[i];
    counts[0] = static_cast<int32_t>(m.vertices.size() / 3);
    counts[1] = static_cast<int32_t>(m.texcrds.size() / 2);
    counts[2] = static_cast<int32_t>(m.normals.size() / 3);
    counts[3] = static_cast<int32_t>(m.tri_m.size());
    counts[4] = static_cast<int32_t>(m.slot_names.size());
}

void rz_obj_mesh_data(void* h, int i, float* v, float* t, float* n,
                      int32_t* tri_v, int32_t* tri_t, int32_t* tri_n,
                      int32_t* tri_m) {
    const MeshOut& m = static_cast<ObjResult*>(h)->meshes[i];
    std::memcpy(v, m.vertices.data(), m.vertices.size() * sizeof(float));
    std::memcpy(t, m.texcrds.data(), m.texcrds.size() * sizeof(float));
    std::memcpy(n, m.normals.data(), m.normals.size() * sizeof(float));
    std::memcpy(tri_v, m.tri_v.data(), m.tri_v.size() * sizeof(int32_t));
    std::memcpy(tri_t, m.tri_t.data(), m.tri_t.size() * sizeof(int32_t));
    std::memcpy(tri_n, m.tri_n.data(), m.tri_n.size() * sizeof(int32_t));
    std::memcpy(tri_m, m.tri_m.data(), m.tri_m.size() * sizeof(int32_t));
}

const char* rz_obj_mesh_slot_name(void* h, int i, int slot) {
    return static_cast<ObjResult*>(h)->meshes[i].slot_names[slot].c_str();
}

int rz_obj_mtllib_count(void* h) {
    return static_cast<int>(static_cast<ObjResult*>(h)->mtllibs.size());
}

const char* rz_obj_mtllib(void* h, int i) {
    return static_cast<ObjResult*>(h)->mtllibs[i].c_str();
}

int rz_obj_log_count(void* h) {
    return static_cast<int>(static_cast<ObjResult*>(h)->log.size());
}

const char* rz_obj_log_entry(void* h, int i, int32_t* level) {
    const LogEntry& e = static_cast<ObjResult*>(h)->log[i];
    *level = e.level;
    return e.text.c_str();
}

}  // extern "C"
