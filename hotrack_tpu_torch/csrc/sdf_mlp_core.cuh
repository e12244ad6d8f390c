// The distilled-SDF MLP for one tile of points, shared by the kernels that
// evaluate it (sdf_mlp.cu, obj_energy.cu; the hand-energy kernels will include
// it too).
//
// Computes what `_sdf_mlp_core` of hotrack_tpu/ops/pallas/hand_energy.py
// computes for the TPU kernels: per point, Fourier features
//   s*x | sin(f*s*x) axis-major, frequency-minor | cos likewise   (3 + 6F)
// then Dense + ReLU hidden layers, a Dense layer to one value, and a clamp to
// [-clamp, clamp]. Not carried over from the TPU: the lane layout, the
// double-angle recurrence with its first-layer permutation (every sine and
// cosine here is sinf / cosf of the float32 product f * (s * x), as the plain
// PyTorch version computes it), and bf16 operands.
//
// Precision: float32 FMA with float32 accumulation, no tensor cores. A hidden
// unit is sum_k a[k] * w[k][unit] accumulated in ascending k from 0, then
// + bias; the output is the sum over units in a fixed order. Nothing depends
// on the launch, so two launches agree bitwise.
//
// Bound: operations. One point costs 2 * (K0*H + H*H*(depth-1) + H) float32
// operations (71,168 at 21-128-128-128-1) against 12 bytes in and 4 out.
//
// Design: a block of 256 threads takes a tile of 128 points. The tile's
// activations live in shared memory as act[unit][point] (64 KB), the weights
// are read through L1/L2 with __ldg (142 KB for the shipped net, shared by all
// blocks). Thread (tx, ty) = (tid % 16, tid / 16) holds an 8 x 8 register
// tile: points 4tx..4tx+3 and 64+4tx..+3 by units 4ty..4ty+3 and 64+4ty..+3,
// so one step in k is two 16-byte loads of activations, two of weights, and 64
// FMAs. A layer is computed from act into registers, then, after a barrier,
// written back over act. The last hidden layer is not written back: its
// ReLU output is multiplied into the output layer's weights in registers, the
// 16 partial sums per point go through shared memory (red[ty][point]) and are
// added in ascending ty.
//
// Packed parameters (float32, every offset a multiple of 4 floats), built by
// hotrack_tpu_torch/ops/sdf_mlp.py pack_distilled:
//   [0] scale  [1] clamp  [2..3] 0
//   freqs, padded with 0 to a multiple of 4
//   per hidden layer l: W_l as [K_l][128] (outputs beyond the layer's width
//     are 0), then bias [128]
//   output layer: weights [128] (0 beyond the last hidden width), bias, 0 0 0

#pragma once

#include <cuda_runtime.h>

namespace hotrack {

constexpr int kTilePoints = 128;
constexpr int kMaxWidth = 128;   // widest layer (features or hidden units)
constexpr int kMlpThreads = 256;
constexpr int kMaxHidden = 8;
constexpr int kActFloats = kMaxWidth * kTilePoints;
constexpr int kRedFloats = 16 * kTilePoints;
constexpr int kMlpSmemBytes = (kActFloats + kRedFloats) * static_cast<int>(sizeof(float));

struct MlpShape {
  int n_freqs;
  int n_hidden;
  int widths[kMaxHidden + 1];  // widths[0] = 3 + 6F, widths[l] = units of hidden layer l
};

__host__ __device__ inline int round_up4(int v) { return (v + 3) & ~3; }

// Checks a shape the launchers were given; 0 when the kernels take it.
inline int mlp_shape_error(const MlpShape& s) {
  if (s.n_freqs < 0 || s.n_hidden < 1 || s.n_hidden > kMaxHidden) return 1;
  if (s.widths[0] != 3 + 6 * s.n_freqs) return 1;
  for (int l = 0; l <= s.n_hidden; ++l)
    if (s.widths[l] < 1 || s.widths[l] > kMaxWidth) return 1;
  return 0;
}

inline MlpShape make_mlp_shape(int n_freqs, int n_hidden, const int* widths) {
  MlpShape s{};
  s.n_freqs = n_freqs;
  s.n_hidden = n_hidden;
  for (int l = 0; l <= n_hidden && l <= kMaxHidden; ++l) s.widths[l] = widths[l];
  return s;
}

// Writes the features of point slot `tid % 128` into act[feature][slot]. The
// two halves of the block share a slot: both hold its scaled coordinates, each
// takes every other (axis, frequency) pair. The caller puts a barrier between
// this and mlp_tile.
__device__ __forceinline__ void build_features(float* __restrict__ act,
                                               const float* __restrict__ freqs, int n_freqs,
                                               float x0, float x1, float x2) {
  const int slot = threadIdx.x & (kTilePoints - 1);
  const int half = threadIdx.x >> 7;
  if (half == 0) {
    act[0 * kTilePoints + slot] = x0;
    act[1 * kTilePoints + slot] = x1;
    act[2 * kTilePoints + slot] = x2;
  }
  const int pairs = 3 * n_freqs;
  for (int j = half; j < pairs; j += 2) {
    const int axis = j / n_freqs;
    const float x = axis == 0 ? x0 : (axis == 1 ? x1 : x2);
    const float ang = __fmul_rn(x, __ldg(freqs + (j - axis * n_freqs)));
    act[(3 + j) * kTilePoints + slot] = sinf(ang);
    act[(3 + pairs + j) * kTilePoints + slot] = cosf(ang);
  }
}

__device__ __forceinline__ float relu(float v) { return fmaxf(v, 0.0f); }

// The MLP over the tile whose features are in act. Returns, to the threads
// tid < 128, the clamped sdf of point slot tid (0 to the others). Every thread
// of the block calls it. After it returns the caller may write act again at
// once; red is free again after the next barrier.
__device__ __forceinline__ float mlp_tile(float* __restrict__ act, float* __restrict__ red,
                                          const float* __restrict__ layers,
                                          const MlpShape& shape, float clamp) {
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const float* w = layers;
  float4* act4 = reinterpret_cast<float4*>(act);
  for (int l = 0; l < shape.n_hidden; ++l) {
    const int kdim = shape.widths[l];
    float acc[8][8];
#pragma unroll
    for (int u = 0; u < 8; ++u)
#pragma unroll
      for (int p = 0; p < 8; ++p) acc[u][p] = 0.0f;
    const float4* a4 = act4 + tx;                               // a row is 32 float4
    const float4* w4 = reinterpret_cast<const float4*>(w) + ty;
#pragma unroll 4
    for (int k = 0; k < kdim; ++k) {
      const float4 alo = a4[k * 32], ahi = a4[k * 32 + 16];
      const float4 wlo = __ldg(w4 + k * 32), whi = __ldg(w4 + k * 32 + 16);
      const float a[8] = {alo.x, alo.y, alo.z, alo.w, ahi.x, ahi.y, ahi.z, ahi.w};
      const float ww[8] = {wlo.x, wlo.y, wlo.z, wlo.w, whi.x, whi.y, whi.z, whi.w};
#pragma unroll
      for (int u = 0; u < 8; ++u)
#pragma unroll
        for (int p = 0; p < 8; ++p) acc[u][p] = fmaf(ww[u], a[p], acc[u][p]);
    }
    const float* bias = w + kdim * kMaxWidth;
    const float4 blo = __ldg(reinterpret_cast<const float4*>(bias) + ty);
    const float4 bhi = __ldg(reinterpret_cast<const float4*>(bias) + 16 + ty);
    const float b[8] = {blo.x, blo.y, blo.z, blo.w, bhi.x, bhi.y, bhi.z, bhi.w};
    if (l + 1 < shape.n_hidden) {
      __syncthreads();  // every thread has read the layer's input
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int unit = (u < 4 ? 4 * ty + u : 64 + 4 * ty + (u - 4));
        act4[unit * 32 + tx] = make_float4(relu(acc[u][0] + b[u]), relu(acc[u][1] + b[u]),
                                           relu(acc[u][2] + b[u]), relu(acc[u][3] + b[u]));
        act4[unit * 32 + 16 + tx] = make_float4(relu(acc[u][4] + b[u]), relu(acc[u][5] + b[u]),
                                                relu(acc[u][6] + b[u]), relu(acc[u][7] + b[u]));
      }
      __syncthreads();
      w = bias + kMaxWidth;
    } else {
      const float* wout = bias + kMaxWidth;
      const float4 olo = __ldg(reinterpret_cast<const float4*>(wout) + ty);
      const float4 ohi = __ldg(reinterpret_cast<const float4*>(wout) + 16 + ty);
      const float wo[8] = {olo.x, olo.y, olo.z, olo.w, ohi.x, ohi.y, ohi.z, ohi.w};
      float part[8];
#pragma unroll
      for (int p = 0; p < 8; ++p) part[p] = 0.0f;
#pragma unroll
      for (int u = 0; u < 8; ++u)
#pragma unroll
        for (int p = 0; p < 8; ++p) part[p] = fmaf(relu(acc[u][p] + b[u]), wo[u], part[p]);
      float4* red4 = reinterpret_cast<float4*>(red);
      red4[ty * 32 + tx] = make_float4(part[0], part[1], part[2], part[3]);
      red4[ty * 32 + 16 + tx] = make_float4(part[4], part[5], part[6], part[7]);
      __syncthreads();
      float s = 0.0f;
      if (tid < kTilePoints) {
#pragma unroll
        for (int j = 0; j < 16; ++j) s += red[j * kTilePoints + tid];
        s += __ldg(wout + kMaxWidth);
        s = fminf(fmaxf(s, -clamp), clamp);
      }
      return s;
    }
  }
  return 0.0f;
}

}  // namespace hotrack
