// Z-buffer triangle depth rasterizer (the port's copy of the JAX
// package's nice_slam_tpu/native/rasterize.cpp; a replacement for the
// Open3D offscreen depth renders the reference's 2D reconstruction eval
// leans on, src/tools/eval_recon.py:153-204).
//
// Camera convention matches the rest of the framework (x right, y up,
// -z forward; SURVEY §2.1#7):  d = -z_cam,  u = fx*x/d + cx,
// v = -fy*y/d + cy.  Perspective-correct depth via screen-linear 1/d.
// Near-plane clipping in camera space (triangles straddling the plane are
// clipped to a quad); fragments beyond z_far are dropped (Open3D's
// set_constant_z_far(20) analogue).  Empty pixels stay 0 — same as an
// Open3D depth buffer.

#include <cmath>
#include <cstdint>
#include <algorithm>

namespace {

struct V3 {
    float x, y, z;
};

// project camera-space point (z < 0 in front) to screen + inverse depth
inline void project(const V3 &p, float fx, float fy, float cx, float cy,
                    float &u, float &v, float &invd) {
    float d = -p.z;
    invd = 1.0f / d;
    u = fx * p.x * invd + cx;
    v = -fy * p.y * invd + cy;
}

inline V3 lerp(const V3 &a, const V3 &b, float t) {
    return {a.x + t * (b.x - a.x), a.y + t * (b.y - a.y),
            a.z + t * (b.z - a.z)};
}

void raster_tri(const V3 *p, float fx, float fy, float cx, float cy,
                int64_t H, int64_t W, float z_far, float *zbuf) {
    float u[3], v[3], w[3];
    for (int i = 0; i < 3; ++i)
        project(p[i], fx, fy, cx, cy, u[i], v[i], w[i]);

    float area = (u[1] - u[0]) * (v[2] - v[0]) -
                 (u[2] - u[0]) * (v[1] - v[0]);
    if (std::fabs(area) < 1e-12f) return;
    float inv_area = 1.0f / area;

    float umin = std::min({u[0], u[1], u[2]});
    float umax = std::max({u[0], u[1], u[2]});
    float vmin = std::min({v[0], v[1], v[2]});
    float vmax = std::max({v[0], v[1], v[2]});
    int64_t x0 = std::max<int64_t>(0, (int64_t)std::floor(umin));
    int64_t x1 = std::min<int64_t>(W - 1, (int64_t)std::ceil(umax));
    int64_t y0 = std::max<int64_t>(0, (int64_t)std::floor(vmin));
    int64_t y1 = std::min<int64_t>(H - 1, (int64_t)std::ceil(vmax));
    if (x0 > x1 || y0 > y1) return;

    for (int64_t y = y0; y <= y1; ++y) {
        float py = (float)y;
        for (int64_t x = x0; x <= x1; ++x) {
            float px = (float)x;
            // barycentric weights (edge functions)
            float b0 = ((u[1] - px) * (v[2] - py) -
                        (u[2] - px) * (v[1] - py)) * inv_area;
            float b1 = ((u[2] - px) * (v[0] - py) -
                        (u[0] - px) * (v[2] - py)) * inv_area;
            float b2 = 1.0f - b0 - b1;
            if (b0 < 0.f || b1 < 0.f || b2 < 0.f) continue;
            float invd = b0 * w[0] + b1 * w[1] + b2 * w[2];
            if (invd <= 0.f) continue;
            float d = 1.0f / invd;
            if (d > z_far) continue;
            float &z = zbuf[y * W + x];
            if (z == 0.0f || d < z) z = d;
        }
    }
}

}  // namespace

extern "C" {

// verts: (n_verts, 3) world f32; tris: (n_tris, 3) int64;
// w2c: 4x4 row-major world->camera; out: (H, W) f32 preallocated, any
// contents overwritten (0 = no geometry).
void raster_depth(const float *verts, int64_t n_verts, const int64_t *tris,
                  int64_t n_tris, const float *w2c, int64_t H, int64_t W,
                  float fx, float fy, float cx, float cy, float z_near,
                  float z_far, float *out) {
    std::fill(out, out + H * W, 0.0f);
    const float *R = w2c;  // rows: R[0..3], R[4..7], R[8..11]

    const float zcap = -z_near;  // camera-space z must be < -z_near
    for (int64_t t = 0; t < n_tris; ++t) {
        V3 c[3];
        bool in_front[3];
        int n_front = 0;
        for (int k = 0; k < 3; ++k) {
            const float *pw = verts + 3 * tris[3 * t + k];
            c[k].x = R[0] * pw[0] + R[1] * pw[1] + R[2] * pw[2] + R[3];
            c[k].y = R[4] * pw[0] + R[5] * pw[1] + R[6] * pw[2] + R[7];
            c[k].z = R[8] * pw[0] + R[9] * pw[1] + R[10] * pw[2] + R[11];
            in_front[k] = c[k].z < zcap;
            n_front += in_front[k];
        }
        if (n_front == 0) continue;
        if (n_front == 3) {
            raster_tri(c, fx, fy, cx, cy, H, W, z_far, out);
            continue;
        }
        // clip against the near plane z = -z_near
        V3 poly[4];
        int np = 0;
        for (int k = 0; k < 3; ++k) {
            const V3 &a = c[k];
            const V3 &b = c[(k + 1) % 3];
            bool ain = in_front[k], bin = in_front[(k + 1) % 3];
            if (ain) poly[np++] = a;
            if (ain != bin) {
                float tt = (zcap - a.z) / (b.z - a.z);
                poly[np++] = lerp(a, b, tt);
            }
        }
        if (np >= 3) {
            V3 tri1[3] = {poly[0], poly[1], poly[2]};
            raster_tri(tri1, fx, fy, cx, cy, H, W, z_far, out);
            if (np == 4) {
                V3 tri2[3] = {poly[0], poly[2], poly[3]};
                raster_tri(tri2, fx, fy, cx, cy, H, W, z_far, out);
            }
        }
    }
    (void)n_verts;
}

}  // extern "C"
