// The distilled-SDF MLP on Hopper's tensor cores through mma.sync, at
// float32-class precision (3xTF32), for the 3xTF32 instantiations of
// obj_energy.cu (#4, #4b) and hand_energy_skin.cu (#7, #7b). Their bf16
// instantiations, sdf_mlp.cu (#3, #3b) and hand_energy.cu (#6) run the MLP
// through wgmma on the persistent walk of sdf_mlp_wgmma.cuh (which takes this
// header's rounding and shape check).
//
// Computes what `_sdf_mlp_core` of hotrack_tpu/ops/pallas/hand_energy.py
// computes for the TPU kernels: per point, Fourier features
//   s*x | sin(f*s*x) axis-major, frequency-minor | cos likewise   (3 + 6F)
// each sine and cosine sinf / cosf of the float32 product f * (s * x), as
// the plain PyTorch version computes them; then Dense + ReLU hidden layers,
// a Dense layer to one value, and a clamp to [-clamp, clamp].
//
// Precision: 3xTF32. Every operand x of a hidden-layer product is split as
// big = tf32(x), small = tf32(x - big) (round to nearest, ties away from 0,
// on the 13 low mantissa bits: tf32_round below, the same integer rule as
// ops/tf32.py), and a product is big*big + big*small + small*big, summed in
// float32 by the tensor cores (whose accumulation truncates: k_step);
// small*small (2^-22 of a product) is dropped. The weights are split once,
// when they are packed; the activations after each layer's bias and ReLU.
// Products of two TF32 values are exact in float32, so the result differs
// from a float32 FMA chain by the dropped term, the tensor cores' truncating
// accumulation and the summation order. The 128 -> 1 output layer and the
// clamp stay float32 FMA.
//
// Bound: operations. 3 x 2 x (K0 H + H H (depth - 1)) tensor-core operations
// a point at TF32's 495 TFLOP/s (3 x 71,168 at 21-128-128-128-1: 0.904 ms for
// 2048 x 1024 points, against 2.228 ms for the same work in float32 FMA at 67
// TFLOP/s), plus the output layer in float32.
//
// Instruction: mma.sync.aligned.m16n8k8 .tf32 with float32 accumulators.
// mma.sync takes B from registers, so a weight's small half can sit in shared
// memory as fp16 and the whole net stays resident (below), and the
// activations never leave the registers. The price: mma.sync does not reach
// the tensor cores' full rate on Hopper (wgmma does), so these kernels stay
// well above the 3xTF32 bound (PERF.md). wgmma reads B only from shared
// memory, K-major for .tf32, both halves of every weight as 32-bit words:
// 287,776 bytes for the shipped net, above a block's 232,448, so
// sdf_mlp_wgmma.cuh streams part of them through a ring of tiles.
//
// Design, for one block of kThreads = 256 threads (8 warps):
// - Weights: big halves as float32 words (their low 13 bits 0), small halves
//   as fp16 words of small * 2^12 (exact: a TF32 value has 11 significant
//   bits, as fp16 has; the A side meets them with big * 2^-12, also exact),
//   so a weight takes 6 bytes and no instruction to split. The layers after
//   the first are copied into shared memory once and stay there for the
//   block's whole life (2 x 98,816 = 197,632 bytes for 21-128-128-128-1; the
//   caller adds its own few KB); layer 0 (K0 x 128, 18 KB at K0 = 24) is read
//   from device memory through L1. Only when a deep net does not fit (depth 4
//   and more at width 128) is each later layer copied in at its turn, every
//   128 points ("staged").
// - A round is 128 points: warp w takes points 16 w .. 16 w + 15 as the M
//   = 16 rows of its mma tiles; lane (g, t) = (lane / 4, lane % 4) holds rows
//   g and g + 8. A layer's 128 outputs are 16 n-tiles of 8, 64 float32
//   accumulators a thread. Hidden widths below 128 are padded with zero
//   weights and biases (their ReLU outputs are exactly 0).
// - The accumulator of one layer is the A fragment of the next with no data
//   movement: a thread's accumulators hold units 8 j + 2 t and 8 j + 2 t + 1
//   of k-block j, the A fragment wants its k-slots t and t + 4, so
//   pack_distilled stores the next layer's rows of k-block j in the order of
//   units 0 2 4 6 1 3 5 7 (ops/sdf_mlp.py _tc_rows). Activations between
//   layers never reach shared or device memory.
// - Fragment order: big weights are [k-step][n-tile pair][lane][4] (b0 b1 of
//   n-tile 2 p, then of 2 p + 1), small ones [k-step][n-tile quad][lane][8]
//   (b0 b1 of n-tiles 4 q .. 4 q + 3), so a lane loads 16 bytes at a time and
//   a warp 512 consecutive bytes: no bank conflicts.
// - Layer 0 (K0 = 3 + 6F padded to a multiple of 8 with zero weights) builds
//   its A fragments from the features directly: each of a point's features
//   is computed by exactly one lane of the four that hold its row.
// - Order: every sum has one fixed order (k-steps ascending; the output
//   layer's 32 terms a lane in ascending n-tile, then lanes t = 0 1 2 3 by a
//   butterfly), so two launches agree bitwise, and the grid and the block a
//   point lands on change nothing.
//
// Packed parameters (float32 words, every part a multiple of 4 of them),
// built by hotrack_tpu_torch/ops/sdf_mlp.py pack_distilled (PackedSDF.tc):
//   [0] scale  [1] clamp  [2..3] 0
//   freqs, padded with 0 to a multiple of 4
//   per hidden layer (K = K0p for layer 0, 128 after; rows of the later
//   layers in _tc_rows' order): big weights, K x 128 floats in fragment order;
//   small weights, K x 128 fp16 in fragment order (K x 64 words); bias [128]
//   output layer: weights [128], bias, 0 0 0

#pragma once

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hotrack {
namespace tc {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16;                       // points a warp a round: the mma's M
constexpr int kRoundPoints = kWarps * kRows;    // 128
constexpr int kUnits = 128;                     // every hidden layer, padded
constexpr int kNTiles = kUnits / 8;             // 16 n-tiles of 8 units, 16 k-steps of 8
constexpr int kMaxHidden = 8;
constexpr float kSmallUnscale = 1.0f / 4096.0f; // the small halves are stored times 2^12
// a layer's floats for K input rows: big weights (K x 128 floats), small
// weights (K x 128 halves), bias (128)
__host__ __device__ inline int block_floats(int k) { return k * (kUnits + kUnits / 2) + kUnits; }
constexpr int kHiddenFloats = kUnits * (kUnits + kUnits / 2) + kUnits;   // a layer l >= 1

struct Shape {
  int n_freqs;
  int n_hidden;
  int k0;        // 3 + 6F rounded up to a multiple of 8
};

__host__ __device__ inline int round_up4(int v) { return (v + 3) & ~3; }
__host__ __device__ inline int round_up8(int v) { return (v + 7) & ~7; }

// From layer 0's block to layer l's, in floats.
__host__ __device__ inline long long layer_offset(const Shape& s, int l) {
  return l == 0 ? 0LL : block_floats(s.k0) + static_cast<long long>(l - 1) * kHiddenFloats;
}
__host__ __device__ inline int header_floats(const Shape& s) { return 4 + round_up4(s.n_freqs); }
// Shared-memory floats for the weights: every layer after the first
// (resident for the block's life), or one of them (staged).
__host__ __device__ inline long long weight_smem_floats(const Shape& s, bool resident) {
  const long long later = s.n_hidden - 1;
  return (resident ? later : (later > 0 ? 1 : 0)) * kHiddenFloats;
}

// The shape of a model the launchers were given (widths[0] = 3 + 6F,
// widths[l] = units of hidden layer l), or k0 = 0 when the kernels do not
// take it: 1 to 8 hidden layers, no layer wider than 128.
inline Shape make_shape(int n_freqs, int n_hidden, const int* widths) {
  Shape s{n_freqs, n_hidden, 0};
  if (n_freqs < 0 || n_hidden < 1 || n_hidden > kMaxHidden) return s;
  if (widths[0] != 3 + 6 * n_freqs) return s;
  for (int l = 0; l <= n_hidden; ++l)
    if (widths[l] < 1 || widths[l] > kUnits) return s;
  s.k0 = round_up8(widths[0]);
  return s;
}

// Whether the later layers stay in shared memory for the block's life (1) or
// are staged (0), given the other bytes the kernel needs and what a block may
// have; -1 when even one staged layer does not fit.
inline int resident_mode(const Shape& s, long long other_bytes, long long limit) {
  const long long f = static_cast<long long>(sizeof(float));
  if (other_bytes + f * weight_smem_floats(s, true) <= limit) return 1;
  if (other_bytes + f * weight_smem_floats(s, false) <= limit) return 0;
  return -1;
}

// x rounded to TF32 (10 mantissa bits) to nearest, ties away from zero, as a
// 32-bit pattern with the 13 low bits 0.
__device__ __forceinline__ uint32_t tf32_round(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// An activation's halves for the A fragments: big, small, and big * 2^-12
// (exact), which meets the small weights stored times 2^12.
struct ASplit {
  uint32_t big[4], small[4], big_lo[4];
};

__device__ __forceinline__ void split_a(ASplit& a, int i, float x) {
  a.big[i] = tf32_round(x);
  const float big = __uint_as_float(a.big[i]);
  a.small[i] = tf32_round(__fsub_rn(x, big));
  a.big_lo[i] = __float_as_uint(__fmul_rn(big, kSmallUnscale));
}

// d = a * b + d for one m16n8k8 tile (not volatile: the compiler may
// interleave independent tiles).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <bool kGlobal, typename T>
__device__ __forceinline__ T load(const T* p) {
  if constexpr (kGlobal) return __ldg(p);
  else return *p;
}

// The two fp16 of a 32-bit word as float32 patterns (low half first).
__device__ __forceinline__ uint2 halves_to_f32(uint32_t word) {
  const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&word));
  return make_uint2(__float_as_uint(f.x), __float_as_uint(f.y));
}

// One k-step of 8 against all 16 n-tiles, four n-tiles at a time: big4 and
// small4 point at the step's fragments (kGlobal: in device memory, read
// through L1; else in shared memory). Each tile takes the step's three
// products (small*big, big*small, big*big) into its running sum, the four
// tiles' mma pass by pass, so that none waits for the one just before it.
// The tensor cores' float32 accumulation truncates toward zero, so a sum
// chained through a layer's 48 products comes out up to about 1.6e-6 of its
// size low (an object energy on the card, against 3.5e-7 with each step's
// part in a fresh accumulator added in float32: measured on the card, that
// costs 35% more time, in registers the compiler spills).
template <bool kGlobal>
__device__ __forceinline__ void k_step(float (&acc)[kNTiles][4], const ASplit& a,
                                       const float4* __restrict__ big4,
                                       const uint4* __restrict__ small4, int lane) {
  constexpr int G = 4;   // n-tiles a pass (8 and 16 measured no faster)
#pragma unroll
  for (int q = 0; q < kNTiles / G; ++q) {
    uint32_t bb[G][2], sv[G];
#pragma unroll
    for (int h = 0; h < G / 2; ++h) {
      const float4 w = load<kGlobal>(big4 + (q * G / 2 + h) * 32 + lane);
      bb[2 * h][0] = __float_as_uint(w.x);
      bb[2 * h][1] = __float_as_uint(w.y);
      bb[2 * h + 1][0] = __float_as_uint(w.z);
      bb[2 * h + 1][1] = __float_as_uint(w.w);
    }
#pragma unroll
    for (int h = 0; h < G / 4; ++h) {
      const uint4 sw = load<kGlobal>(small4 + (q * G / 4 + h) * 32 + lane);
      sv[4 * h] = sw.x;
      sv[4 * h + 1] = sw.y;
      sv[4 * h + 2] = sw.z;
      sv[4 * h + 3] = sw.w;
    }
    float (&sum)[G][4] = *reinterpret_cast<float (*)[G][4]>(&acc[G * q]);
#pragma unroll
    for (int j = 0; j < G; ++j) mma_tf32(sum[j], a.small, bb[j][0], bb[j][1]);
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const uint2 bs = halves_to_f32(sv[j]);
      mma_tf32(sum[j], a.big_lo, bs.x, bs.y);
    }
#pragma unroll
    for (int j = 0; j < G; ++j) mma_tf32(sum[j], a.big, bb[j][0], bb[j][1]);
  }
}

// A layer's big and small weights and bias, from the start of its block.
struct Layer {
  const float4* big4;
  const uint4* small4;
  const float* bias;
};

__device__ __forceinline__ Layer layer_at(const float* block, int k) {
  return {reinterpret_cast<const float4*>(block),
          reinterpret_cast<const uint4*>(block + k * kUnits),
          block + k * (kUnits + kUnits / 2)};
}

__device__ __forceinline__ float pick3(const float (&x)[3], int i) {
  return i == 0 ? x[0] : (i == 1 ? x[1] : x[2]);
}

// Feature c of a point with scaled coordinates x: x_c, then the sines, then
// the cosines (axis-major, frequency-minor), then 0 up to K0p.
__device__ __forceinline__ float feature(const float (&x)[3], int c,
                                         const float* __restrict__ freqs, int n_freqs) {
  if (c < 3) return pick3(x, c);
  const int pairs = 3 * n_freqs;
  int j = c - 3;
  if (j >= 2 * pairs) return 0.0f;
  const bool is_cos = j >= pairs;
  if (is_cos) j -= pairs;
  const int axis = j / n_freqs;
  const float ang = __fmul_rn(pick3(x, axis), __ldg(freqs + (j - axis * n_freqs)));
  return is_cos ? cosf(ang) : sinf(ang);
}

__device__ __forceinline__ void zero(float (&acc)[kNTiles][4]) {
#pragma unroll
  for (int nt = 0; nt < kNTiles; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] = 0.0f;
}

// Layer 0 on rows g (features of xa) and g + 8 (xb); its weights are read
// from device memory through L1 (18 KB at K0 = 24).
__device__ __forceinline__ void first_layer(float (&acc)[kNTiles][4], const float (&xa)[3],
                                            const float (&xb)[3], const float* __restrict__ freqs,
                                            const Shape& s, const Layer& w, int lane) {
  zero(acc);
  const int t = lane & 3;
  for (int ks = 0; ks < s.k0 / 8; ++ks) {
    const int c0 = 8 * ks + t, c1 = c0 + 4;
    ASplit a;
    split_a(a, 0, feature(xa, c0, freqs, s.n_freqs));
    split_a(a, 1, feature(xb, c0, freqs, s.n_freqs));
    split_a(a, 2, feature(xa, c1, freqs, s.n_freqs));
    split_a(a, 3, feature(xb, c1, freqs, s.n_freqs));
    k_step<true>(acc, a, w.big4 + ks * (kNTiles / 2) * 32, w.small4 + ks * (kNTiles / 4) * 32,
                 lane);
  }
}

// A hidden layer l >= 1 from shared memory: act holds the previous layer's
// outputs in accumulator order, which is this layer's A-fragment order
// (_tc_rows' order).
__device__ __forceinline__ void hidden_layer(float (&acc)[kNTiles][4],
                                             const float (&act)[kNTiles][4], const Layer& w,
                                             int lane) {
  zero(acc);
#pragma unroll
  for (int ks = 0; ks < kNTiles; ++ks) {
    ASplit a;
    split_a(a, 0, act[ks][0]);   // row g,     k-slot t     = unit 8 ks + 2 t
    split_a(a, 1, act[ks][2]);   // row g + 8, k-slot t
    split_a(a, 2, act[ks][1]);   // row g,     k-slot t + 4 = unit 8 ks + 2 t + 1
    split_a(a, 3, act[ks][3]);   // row g + 8, k-slot t + 4
    k_step<false>(acc, a, w.big4 + ks * (kNTiles / 2) * 32, w.small4 + ks * (kNTiles / 4) * 32,
                  lane);
  }
}

__device__ __forceinline__ void bias_relu(float (&act)[kNTiles][4], const float (&acc)[kNTiles][4],
                                          const float* __restrict__ bias, int lane) {
  const int t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < kNTiles; ++nt) {
    const float2 b = *reinterpret_cast<const float2*>(bias + nt * 8 + 2 * t);
    act[nt][0] = fmaxf(acc[nt][0] + b.x, 0.0f);
    act[nt][1] = fmaxf(acc[nt][1] + b.y, 0.0f);
    act[nt][2] = fmaxf(acc[nt][2] + b.x, 0.0f);
    act[nt][3] = fmaxf(acc[nt][3] + b.y, 0.0f);
  }
}

// Block-wide copy of n floats (a multiple of 4, both pointers 16-byte aligned).
__device__ __forceinline__ void copy_floats(float* __restrict__ dst, const float* __restrict__ src,
                                            long long n) {
  const float4* s4 = reinterpret_cast<const float4*>(src);
  float4* d4 = reinterpret_cast<float4*>(dst);
  for (long long i = threadIdx.x; i < n / 4; i += blockDim.x) d4[i] = __ldg(s4 + i);
}

// A model's parts in device memory.
struct Net {
  float scale, clamp;
  const float* freqs;
  const float* layers;   // layer 0's block
  const float* wout;     // output weights [128], then the bias
};

__device__ __forceinline__ Net net_of(const float* __restrict__ packed, const Shape& s) {
  Net n;
  n.scale = __ldg(packed);
  n.clamp = __ldg(packed + 1);
  n.freqs = packed + 4;
  n.layers = packed + header_floats(s);
  n.wout = n.layers + layer_offset(s, s.n_hidden);
  return n;
}

// Makes the block's resident layers (1 .. depth - 1) those of `net`; every
// thread calls it.
__device__ __forceinline__ void load_resident(float* __restrict__ wsm, const Net& net,
                                              const Shape& s) {
  __syncthreads();   // nobody reads the previous weights any more
  copy_floats(wsm, net.layers + layer_offset(s, 1), weight_smem_floats(s, true));
  __syncthreads();
}

// The clamped sdf of the warp's rows g (xa, scaled coordinates) and g + 8
// (xb), returned to every lane of the row's four. Every thread of the block
// calls it (a staged net copies its layers with barriers).
__device__ __forceinline__ float2 mlp_rows(const float (&xa)[3], const float (&xb)[3],
                                           const Net& net, const Shape& s, bool resident,
                                           float* __restrict__ wsm) {
  const int lane = threadIdx.x & 31, t = lane & 3;
  float acc[kNTiles][4], act[kNTiles][4];
  const Layer first = layer_at(net.layers, s.k0);
  first_layer(acc, xa, xb, net.freqs, s, first, lane);
  bias_relu(act, acc, first.bias, lane);
  for (int l = 1; l < s.n_hidden; ++l) {
    const float* block = wsm;
    if (resident) {
      block += static_cast<long long>(l - 1) * kHiddenFloats;
    } else {
      __syncthreads();
      copy_floats(wsm, net.layers + layer_offset(s, l), kHiddenFloats);
      __syncthreads();
    }
    const Layer w = layer_at(block, kUnits);
    hidden_layer(acc, act, w, lane);
    bias_relu(act, acc, w.bias, lane);
  }
  float p0 = 0.0f, p1 = 0.0f;
#pragma unroll
  for (int nt = 0; nt < kNTiles; ++nt) {
    const float2 wo = __ldg(reinterpret_cast<const float2*>(net.wout + nt * 8 + 2 * t));
    p0 = fmaf(act[nt][0], wo.x, p0);
    p0 = fmaf(act[nt][1], wo.y, p0);
    p1 = fmaf(act[nt][2], wo.x, p1);
    p1 = fmaf(act[nt][3], wo.y, p1);
  }
  p0 += __shfl_xor_sync(0xffffffffu, p0, 1);
  p1 += __shfl_xor_sync(0xffffffffu, p1, 1);
  p0 += __shfl_xor_sync(0xffffffffu, p0, 2);
  p1 += __shfl_xor_sync(0xffffffffu, p1, 2);
  const float b = __ldg(net.wout + kUnits);
  return make_float2(fminf(fmaxf(p0 + b, -net.clamp), net.clamp),
                     fminf(fmaxf(p1 + b, -net.clamp), net.clamp));
}

// Blocks of `kernel` (kThreads threads, smem bytes) the device runs at once:
// the persistent grid's size. Remembers the last answer per kernel.
template <typename Kernel>
inline int persistent_blocks(Kernel kernel, long long smem, long long& cached_smem,
                             int& cached_blocks) {
  if (smem != cached_smem) {
    int device = 0, sms = 0, per_sm = 0;
    if (cudaGetDevice(&device) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                      static_cast<size_t>(smem)) != cudaSuccess)
      return 0;
    cached_smem = smem;
    cached_blocks = sms * (per_sm > 0 ? per_sm : 1);
  }
  return cached_blocks;
}

}  // namespace tc
}  // namespace hotrack
