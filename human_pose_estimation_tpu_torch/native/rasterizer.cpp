// Native triangle rasterizer for mesh visualization (the port's copy of
// the JAX package's native/rasterizer.cpp; the code is unchanged).
//
// Fills the role OpenDR's C++/OpenGL ColoredRenderer plays in the
// reference (ref src/util/renderer.py:12-14): z-buffered perspective
// rasterization of the SMPL mesh with flat Lambertian shading. Exposed
// through a C ABI and loaded via ctypes (no pybind11 dependency);
// algorithmically identical to the numpy fallback in viz/renderer.py
// (tests assert pixel parity) but ~2 orders of magnitude faster on the
// 13,776-triangle SMPL mesh.
//
// Build: g++ -O3 -shared -fPIC rasterizer.cpp -o librasterizer.so
// (native/__init__.py does it at first use, into build/native/).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

extern "C" {

// verts: n_verts x 3 camera-frame coordinates (+z into the screen)
// faces: n_faces x 3 vertex indices
// img:   height x width x 3, prefilled with the background, overwritten
//        where the mesh covers pixels
// mask:  height x width, set to 1 where covered
void rasterize_mesh(const double* verts, int64_t n_verts, const int64_t* faces,
                    int64_t n_faces, int64_t height, int64_t width,
                    double focal, double cx, double cy, const double* color,
                    const double* light_dir, double ambient, double* img,
                    uint8_t* mask) {
  std::vector<double> px(n_verts), py(n_verts), pz(n_verts);
  for (int64_t i = 0; i < n_verts; ++i) {
    double z = std::max(verts[3 * i + 2], 1e-6);
    pz[i] = z;
    px[i] = focal * verts[3 * i + 0] / z + cx;
    py[i] = focal * verts[3 * i + 1] / z + cy;
  }

  double ll = std::sqrt(light_dir[0] * light_dir[0] +
                        light_dir[1] * light_dir[1] +
                        light_dir[2] * light_dir[2]);
  double lx = light_dir[0] / ll, ly = light_dir[1] / ll, lz = light_dir[2] / ll;

  std::vector<double> depth((size_t)height * width,
                            std::numeric_limits<double>::infinity());

  for (int64_t f = 0; f < n_faces; ++f) {
    int64_t i0 = faces[3 * f], i1 = faces[3 * f + 1], i2 = faces[3 * f + 2];
    double ax = px[i0], ay = py[i0];
    double bx = px[i1], by = py[i1];
    double ccx = px[i2], ccy = py[i2];

    double det = (bx - ax) * (ccy - ay) - (ccx - ax) * (by - ay);
    if (std::fabs(det) < 1e-12) continue;

    int64_t x0 = std::max<int64_t>(
        0, (int64_t)std::floor(std::min(ax, std::min(bx, ccx))));
    int64_t x1 = std::min<int64_t>(
        width - 1, (int64_t)std::ceil(std::max(ax, std::max(bx, ccx))));
    int64_t y0 = std::max<int64_t>(
        0, (int64_t)std::floor(std::min(ay, std::min(by, ccy))));
    int64_t y1 = std::min<int64_t>(
        height - 1, (int64_t)std::ceil(std::max(ay, std::max(by, ccy))));
    if (x1 < x0 || y1 < y0) continue;

    // flat shading from the camera-space face normal
    double e1x = verts[3 * i1] - verts[3 * i0];
    double e1y = verts[3 * i1 + 1] - verts[3 * i0 + 1];
    double e1z = verts[3 * i1 + 2] - verts[3 * i0 + 2];
    double e2x = verts[3 * i2] - verts[3 * i0];
    double e2y = verts[3 * i2 + 1] - verts[3 * i0 + 1];
    double e2z = verts[3 * i2 + 2] - verts[3 * i0 + 2];
    double nx = e1y * e2z - e1z * e2y;
    double ny = e1z * e2x - e1x * e2z;
    double nz = e1x * e2y - e1y * e2x;
    double nn = std::sqrt(nx * nx + ny * ny + nz * nz);
    double lam = nn > 1e-12
                     ? std::fabs((nx * lx + ny * ly + nz * lz) / nn)
                     : 0.0;
    double shade = std::min(1.0, std::max(0.0, ambient + (1 - ambient) * lam));
    double r = color[0] * shade, g = color[1] * shade, b = color[2] * shade;

    double iz0 = 1.0 / pz[i0], iz1 = 1.0 / pz[i1], iz2 = 1.0 / pz[i2];

    for (int64_t y = y0; y <= y1; ++y) {
      double gy = y + 0.5;
      for (int64_t x = x0; x <= x1; ++x) {
        double gx = x + 0.5;
        double w0 = ((bx - ax) * (gy - ay) - (gx - ax) * (by - ay)) / det;
        double w1 = ((gx - ax) * (ccy - ay) - (ccx - ax) * (gy - ay)) / det;
        double w2 = 1.0 - w0 - w1;
        if (w0 < 0 || w1 < 0 || w2 < 0) continue;
        // perspective-correct depth via interpolated 1/z
        double inv_z = w2 * iz0 + w1 * iz1 + w0 * iz2;
        double zpix = 1.0 / std::max(inv_z, 1e-12);
        size_t idx = (size_t)y * width + x;
        if (zpix >= depth[idx]) continue;
        depth[idx] = zpix;
        img[3 * idx] = r;
        img[3 * idx + 1] = g;
        img[3 * idx + 2] = b;
        mask[idx] = 1;
      }
    }
  }
}

}  // extern "C"
