// Native host-side point-cloud preprocessing.
//
// The reference's data loaders run a multi-pass numpy/open3d pipeline per
// frame (HO3D_dataset.py:66-111, DexYCB_dataset.py:76-109): depth decode,
// back-projection, segmentation split, radius filtering — each pass
// materializing full-frame intermediates. This library fuses them into a
// single traversal over the depth image (one cache pass, no intermediates),
// exposed through a plain C interface, loaded with ctypes.
//
// Built at first use by hotrack_tpu_torch/native/__init__.py (g++, see the
// flags there) into build/native/ at the repository root.

#include <cstdint>
#include <cmath>

extern "C" {

// Decode HO3D's 2-channel PNG depth encoding: depth = (B + G*256) * scale
// (HO3D_dataset.py:38-45). img is HxWx3 uint8 (BGR as loaded by cv2).
void decode_ho3d_depth(const uint8_t* img, int h, int w, float scale,
                       float* out_depth) {
  const int n = h * w;
  for (int i = 0; i < n; ++i) {
    const uint8_t b = img[i * 3 + 2];
    const uint8_t g = img[i * 3 + 1];
    out_depth[i] = (static_cast<float>(b) + static_cast<float>(g) * 256.0f)
                   * scale;
  }
}

// Fused back-projection + segmentation split + radius filter.
//
//   depth:  HxW float32 (meters)
//   mask:   HxW uint8 segmentation labels
//   label:  the label selecting this part's pixels
//   fx/fy/cx/cy: pinhole intrinsics; x = (col-cx)*z/fx, y = (row-cy)*z/fy
//   sign_y/sign_z: axis flips (HO3D uses -1/-1, HO3D_dataset.py:104-105)
//   center/radius: keep points with ||p - center|| < radius (radius <= 0
//                  disables the filter)
//   stride: pixel stride (DexYCB uses 2, DexYCB_dataset.py:98)
//
// Writes up to max_out xyz triples into out_xyz; returns the count.
int backproject_filter(const float* depth, const uint8_t* mask, int h, int w,
                       uint8_t label, float fx, float fy, float cx, float cy,
                       float sign_y, float sign_z, const float* center,
                       float radius, int stride, float* out_xyz,
                       int max_out) {
  int count = 0;
  const float r2 = radius * radius;
  const bool use_radius = radius > 0.0f;
  for (int row = 0; row < h; row += stride) {
    const int base = row * w;
    for (int col = 0; col < w; col += stride) {
      const int i = base + col;
      if (mask != nullptr && mask[i] != label) continue;
      const float z = depth[i];
      if (z <= 1e-6f) continue;
      const float x = (static_cast<float>(col) - cx) * z / fx;
      float y = (static_cast<float>(row) - cy) * z / fy;
      float zz = z;
      y *= sign_y;
      zz *= sign_z;
      if (use_radius) {
        const float dx = x - center[0];
        const float dy = y - center[1];
        const float dz = zz - center[2];
        if (dx * dx + dy * dy + dz * dz >= r2) continue;
      }
      if (count >= max_out) return count;
      out_xyz[count * 3 + 0] = x;
      out_xyz[count * 3 + 1] = y;
      out_xyz[count * 3 + 2] = zz;
      ++count;
    }
  }
  return count;
}

// Uniform presubsample without replacement via an in-place partial
// Fisher-Yates over an index array supplied by the caller (deterministic
// given the caller's RNG-filled swap targets). points (N,3) -> out (take,3).
void gather_points(const float* points, const int32_t* idx, int take,
                   float* out) {
  for (int i = 0; i < take; ++i) {
    const int j = idx[i];
    out[i * 3 + 0] = points[j * 3 + 0];
    out[i * 3 + 1] = points[j * 3 + 1];
    out[i * 3 + 2] = points[j * 3 + 2];
  }
}

}  // extern "C"
