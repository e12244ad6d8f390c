// The distilled-SDF MLP on Hopper's warpgroup tensor-core instruction
// (wgmma), at float32-class precision (3xTF32) or in bf16, and the persistent
// walk of 128-point rounds around it: the port's one MLP core. sdf_mlp.cu
// (#3, #3b), hand_energy.cu (#6), obj_energy.cu (#4, #4b) and
// hand_energy_skin.cu (#7, #7b) instantiate the walk in both precisions
// (template parameter kBf16). The kernels differ in how a point is read, how a
// round is stored or summed and what the producer warpgroup's spare warps do
// (`walk`, `Job` below).
//
// bf16 (kBf16, HOTRACK_SDF_BF16; the JAX package's compute_dtype bfloat16):
// every layer's input activations and weights, the output layer's included,
// rounded to bf16 to nearest, ties to even (cvt.rn.bf16x2.f32; the weights when
// they are packed, ops/sdf_mlp.py _pack_wg16), exact products summed in float32
// by the tensor cores, bias, ReLU, output layer (float32 FMA on bf16-rounded
// values) and clamp in float32. Instruction:
// wgmma.mma_async.m64n128k16.f32.bf16.bf16, A from registers (4 words of two
// bf16 a thread: rows g and g + 8, k-slots 2 t, 2 t + 1, 2 t + 8, 2 t + 9), B
// from a tile of shared memory (K-major, no transpose); one wgmma a k-step of
// 16 into one accumulator, where 3xTF32
// takes three a k-step of 8 into two. The C fragments of n-tiles 2 k and
// 2 k + 1, bias added and ReLU'd, are k-step k's A fragment after
// cvt.rn.bf16x2.f32, with the units in their natural order, so the later
// layers' rows are in order. Layer 0 (K0 = 3 + 6F) pairs each angle's sine and
// cosine in one register (_wg16_rows, ops/sdf_mlp.py): one sincosf a lane a
// row an angle, (3F + 10) / 8 k-steps (2 for 21-128-128-128-1: K0 padded to
// 32). A bf16 tile of a k-step of 16 and 128 units is 4096 bytes, as a TF32
// tile of a k-step of 8: the descriptor, plan() and the ring are the same, and
// 21-128-128-128-1 is 2 + 8 + 8 = 18 tiles (73,728 bytes), all pinned; depth
// 8 at width 128 is 58 tiles, of which the ring streams 11.
// bf16 bound and schedule: one bf16 pass at 989 TFLOP/s is 0.151 ms for 2048 x
// 1024 points, but what bounds the kernel on this card is the consumer warps'
// CUDA-core issue: per round a warp runs the features (six sincosf, most of a
// round's dependent latency), the bias, ReLU and paired conversion of 256
// hidden activations (FMNMX and F2FP at half the FADD rate) and the output
// layer's 128 FMAs in two chains, beside 18 products a warpgroup that the
// tensor cores finish in 1,152 cycles; a consumer round takes about 5,500 SM
// cycles (scripts/profile_bf16_walk.py --phases) and two warps a scheduler do
// not hide it. The schedule therefore cuts what the consumers issue and wait
// for, and keeps each point's arithmetic: the model's head (scale, clamp,
// frequencies, biases, output layer) is copied to shared memory with the
// pinned tiles, where from device memory every round began by waiting for its
// scale and frequencies, which the streamed points push out of L1; layer 0's
// two k-steps are issued back to back and a pinned layer's eight as one
// group, one wait each (the per-k-step ring handshake only for streamed
// tiles); the output layer rounds two activations a cvt.rn.bf16x2.f32 and
// takes each out of the packed word; the walk divides by 32 bits where the
// items fit. The same k-steps in the same order into one float32 accumulator,
// the same roundings: every value is bitwise what the one-k-step-at-a-time
// schedule computed. Ping-pong turns of
// the two consumer warpgroups (named barriers) and the features on the aside
// warps (a staged feature slot) were measured and lost: the tensor cores are
// not what the warps wait for, and three aside warps are slower at the
// features than eight consumer warps (PERF.md, section 6).
//
// 3xTF32 (the default): per point, Fourier features s*x | sin(f*s*x) |
// cos(f*s*x) (axis-major, frequency-minor; sincosf of the float32 product,
// sinf's and cosf's arithmetic), Dense + ReLU hidden layers whose products are
// 3xTF32 (every operand split as big = tf32(x), small = tf32(x - big), rounded
// to nearest with ties away from zero by tf32_round, the rule of ops/tf32.py;
// small*small dropped), then the 128 -> 1 output layer and the clamp in
// float32 FMA. A layer's big*big products go into one float32 accumulator
// chain (dm) and its small*big and big*small products into another (dc),
// added once in float32 before the bias. The tensor cores truncate as they
// accumulate, so the chain that carries the layer's size truncates 16 times a
// layer (the small products' chain is 2^-11 of its size): one sdf value lay up
// to 1.34e-7 from the plain version's on the card at depth 8 (2.1e-7 and
// 3.4e-7 with one chain of all 48 products at the shipped width and at depth
// 8), inside TC_SDF_ATOL.
//
// Bound: operations, 3 x 2 x (K0 H + H H (depth - 1)) tensor-core operations
// a point at TF32's 495 TFLOP/s (0.904 ms for 2048 x 1024 points of
// 21-128-128-128-1). The sm_80 instruction, mma.sync, tops out at 302-323
// TFLOP/s on the H100 (scripts/mma_sync_rate.py); only wgmma reaches the
// tensor cores' full rate, so it is the one instruction of this core.
//
// Instruction: wgmma.mma_async.m64n128k8.f32.tf32.tf32, A (the activations)
// from registers, B (the weights) from shared memory through a matrix
// descriptor. A layer's 128 outputs are one n = 128 tile, 64 points one
// warpgroup's M. Per warp (16 of the 64 rows), the A fragment of a k-step has
// the layout of mma.sync.m16n8k8's (lane (g, t) = (lane / 4, lane % 4): a0 row
// g col t, a1 row g + 8 col t, a2 row g col t + 4, a3 row g + 8 col t + 4) and
// the accumulator that of the m16n8 C fragment, n-tile j in d[4 j .. 4 j + 3]
// (d0 d1 row g cols 8 j + 2 t, + 1; d2 d3 row g + 8). So one layer's
// outputs are the next layer's A fragments with no data movement, given the
// next layer's rows of each k-block of 8 in the order of units 0 2 4 6 1 3 5 7
// (ops/sdf_mlp.py _wg_rows). Layer 0's rows are ordered so that a lane's
// k-slots t and t + 4 are one angle's sine and cosine (_wg_rows): one sincosf
// a lane a row a k-step, where sinf and cosf apart cost 0.3 ms a launch at
// (2048, 3, 1024).
//
// Weights: B is K-major for .tf32 and both halves of a weight are 32-bit
// words (big, and small as a TF32 float32; wgmma has no fp16 B beside a tf32
// A), 8 bytes a weight: 286,720 bytes of tiles for 21-128-128-128-1, above a
// block's 232,448 bytes of shared memory. The packer (ops/sdf_mlp.py
// _pack_wg, PackedSDF.wg) writes every tile in device memory already as its
// shared-memory image: a tile is one k-step's half of a layer, 8 k-slots x 128
// units x 4 bytes = 4096 bytes, the 16 x 2 core matrices of 8 units x 16 bytes
// (units 8 nb .. 8 nb + 7, k-slots 4 kb .. 4 kb + 3) at nb * kSbo + kb * kLbo,
// no swizzle, and the tiles in the order the kernel consumes them: layer by
// layer, k-step by k-step, big then small. The first `pinned` tiles stay in
// shared memory while the block works on one sequence's model; the rest
// stream through a ring of kRing tile slots, each copied by a 1-D bulk copy
// (cp.async.bulk ... mbarrier::complete_tx) onto the slot's "full" mbarrier
// and released by the 8 consumer warps on its "empty" one. No tensor map.
//
// L2 traffic, reckoned before the design was fixed. Streaming every tile for
// every 128-point round would move 286,720 bytes x 16,384 rounds = 4.70 GB
// from L2 a launch at (2048, 3, 1024) (5.2 TB/s at the 0.904 ms bound: of the
// order of what L2 gives). With 48 of the 70 tiles pinned (196,608 bytes,
// beside a ring of 8 slots, 32,768 bytes) 22 stream: 90,112 bytes a round,
// 1.48 GB a launch (1.63 TB/s at the bound; 1.04 TB/s at the 1.42 ms the
// kernel takes), 11.2 GB at (4, 5120, 3, 778). Pinning costs 196,608 bytes a
// block a sequence.
//
// Design, for one block of kThreads = 384 threads an SM on a persistent grid:
// warps 0-3 and 4-7 are two consumer warpgroups at 232 registers a thread,
// warps 8-11 the producer's warpgroup at 40 (setmaxnreg; ptxas gives a
// kernel with wgmma registers by whole warpgroups, so 288 threads got 168 and
// spilled); warp 8 copies, warps 9-11 meet the block's barriers and do the
// kernel's side work for each item (`aside`: #6's silhouette hits, off the
// consumers' path; nothing for #3, #4 and 3xTF32 #7, whose pre-pass stores
// the hits; `build`: bf16 #7's skinning into a stage slot). A work item is a
// round of 128 consecutive points of one sequence, 64 a consumer warpgroup, 16
// a warp; the block walks items b, b + grid, ... in ascending order (a round
// never spans two sequences; #4 walks groups of a candidate's rounds), each
// round's points read during the round before (bf16 #7's taken from the stage
// where the round starts). Entering another sequence, the whole block meets at
// a barrier and the producer copies the new model's pinned tiles (and in bf16
// its head) onto the "pinned" mbarrier. Per round a 3xTF32 consumer warpgroup
// runs layer 0 a k-step at a time, the next k-step's features computed while
// the products run, and each later layer as 16 k-steps: split the k-step's A fragments from the kept
// outputs of the layer before (two sets in turns), wait for a streamed tile,
// fence, issue three wgmmas (small*big and big*small into dc, big*big into
// dm), commit the group; once the next group is issued the one before is done
// and its ring slots go back. Every wgmma follows an explicit fence after any
// code that branches by thread (ptxas otherwise inserts its own and
// serialises the products), and the ring's slot arithmetic is by a
// compile-time kRing (a runtime divisor cost 20% of the time). Registers: 64
// + 64 accumulators, 64 kept outputs and 16 A words a thread.
// A point's value depends on its inputs and its model only, so two launches
// agree bitwise, and sequence s of a batched launch (its points, model and
// output s times their per-sequence strides further on) computes bitwise what
// an unbatched launch on s's inputs computes.
//
// Packed parameters (float32 words, every part a multiple of 4 of them),
// built by hotrack_tpu_torch/ops/sdf_mlp.py _pack_wg (PackedSDF.wg):
//   [0] scale  [1] clamp  [2..3] 0
//   freqs, padded with 0 to a multiple of 4
//   biases, 128 a hidden layer (0 past its width)
//   output layer: weights [128], bias, 0 0 0
//   tiles, 1024 words each: layer 0's ks0 = (3F + 6) / 4 k-steps (a k-step's
//   k-slots t and t + 4 hold the sine and cosine of angle 4 ks + t, then the 3
//   coordinates, then zero rows: _wg_rows), then 16 k-steps a later layer
//   (128 rows in _wg_rows' order); a k-step's big tile, then its small tile
// and in bf16 (PackedSDF.wg16, _pack_wg16): the same header, biases and
// output layer (its weights rounded to bf16), the head that the walk copies to
// shared memory (Shape.head bytes, a multiple of 16); then one tile of bf16
// weights a k-step of 16 (core matrices of 8 units x 8 k-slots): layer 0's
// (3F + 10) / 8 (_wg16_rows), then 8 a later layer (128 rows in order).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace hotrack {
namespace wg {

constexpr int kConsumerWarps = 8;                 // two warpgroups
constexpr int kThreads = 32 * kConsumerWarps + 128;   // and the producer's warpgroup
constexpr int kProducerWarp = kConsumerWarps;     // the one that copies
constexpr int kAsideThreads = kThreads - 32 * (kProducerWarp + 1);   // warps 9-11: `aside`
constexpr int kConsumerRegs = 232;                // setmaxnreg: 2 x 128 x 232 + 128 x 40
constexpr int kProducerRegs = 40;                 //   = 64,512 of the SM's 65,536
constexpr int kLaunchRegs = (65536 / kThreads) & ~7;   // a thread's at launch: 168
constexpr int kRows = 64;                         // points a warpgroup a round: wgmma's M
constexpr int kRoundPoints = 2 * kRows;
constexpr int kUnits = 128;
constexpr int kMaxKSteps = kUnits / 8;
constexpr int kTileFloats = 8 * kUnits;           // one k-step's half of a layer
constexpr int kTileBytes = 4 * kTileFloats;
constexpr int kRing = 8;                          // slots of streamed tiles
constexpr uint32_t kLbo = 128;                    // from k-slots 0-3 to 4-7 (bytes)
constexpr uint32_t kSbo = 256;                    // from units 8 nb to 8 nb + 8 (bytes)
constexpr int kMaxHidden = 8;

__host__ __device__ inline int round_up4(int v) { return (v + 3) & ~3; }

// x rounded to TF32 (10 mantissa bits) to nearest, ties away from zero, as a
// 32-bit pattern with the 13 low bits 0 (ops/tf32.py tf32_round).
__device__ __forceinline__ uint32_t tf32_round(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

__device__ __forceinline__ float pick3(const float (&x)[3], int i) {
  return i == 0 ? x[0] : (i == 1 ? x[1] : x[2]);
}

struct Shape {
  int n_freqs;
  int n_hidden;
  int ks0;          // layer 0's k-steps: 3F angles and 3 coordinates, 4 a k-step (8 in bf16)
  int tiles;        // 2 (ks0 + 16 (n_hidden - 1)); in bf16 ks0 + 8 (n_hidden - 1)
  int first_tiles;  // layer 0's: 2 ks0; in bf16 ks0
  int head;         // bf16: bytes of the model's head (everything before its tiles), kept in
                    // shared memory beside the tiles; 0 in 3xTF32
};

// Floats of a packed model's header, and before its tiles.
__host__ __device__ inline int header_floats(const Shape& s) {
  return 4 + round_up4(s.n_freqs);
}
__host__ __device__ inline int tiles_offset(const Shape& s) {
  return header_floats(s) + kUnits * s.n_hidden + kUnits + 4;
}

// The shape of a model the launcher was given (widths[0] = 3 + 6F, widths[l]
// = units of hidden layer l), or tiles = 0 when the kernel does not take it:
// 1 to 8 hidden layers, no layer wider than 128.
inline Shape make_shape(int n_freqs, int n_hidden, const int* widths, bool bf16 = false) {
  Shape s{n_freqs, n_hidden, 0, 0, 0, 0};
  if (n_freqs < 0 || n_hidden < 1 || n_hidden > kMaxHidden || widths[0] != 3 + 6 * n_freqs)
    return s;
  for (int l = 0; l <= n_hidden; ++l)
    if (widths[l] < 1 || widths[l] > kUnits) return s;
  if (bf16) {
    s.ks0 = (3 * n_freqs + 10) / 8;
    s.first_tiles = s.ks0;
    s.tiles = s.ks0 + kMaxKSteps / 2 * (n_hidden - 1);
    s.head = 4 * tiles_offset(s);
  } else {
    s.ks0 = (3 * n_freqs + 6) / 4;
    s.first_tiles = 2 * s.ks0;
    s.tiles = 2 * (s.ks0 + kMaxKSteps * (n_hidden - 1));
  }
  return s;
}

// Bytes of the mbarriers: full and empty a ring slot, one for the pinned tiles.
__host__ __device__ inline int barrier_bytes(int ring) { return (8 * (2 * ring + 1) + 15) & ~15; }

// How many tiles stay pinned and how many slots the ring has, for `limit`
// bytes of shared memory a block (the model's head apart): every tile when
// they all fit, else a ring of kRing and as many as fit beside it (at least
// layer 0's). pinned < 0: no room.
inline void plan(const Shape& s, long long limit, int& pinned, int& ring) {
  limit -= s.head;
  ring = 0;
  pinned = s.tiles;
  if (static_cast<long long>(s.tiles) * kTileBytes + barrier_bytes(0) <= limit) return;
  ring = kRing;
  const long long fit = (limit - static_cast<long long>(kRing) * kTileBytes -
                         barrier_bytes(kRing)) / kTileBytes;
  pinned = fit >= s.first_tiles ? static_cast<int>(fit) : -1;
}
__host__ __device__ inline long long smem_bytes(int pinned, int ring) {
  return static_cast<long long>(pinned + ring) * kTileBytes + barrier_bytes(ring);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Returns once the phase of the given parity has completed (the spin loop
// stays inside the asm).
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(bar), "r"(parity)
      : "memory");
}

// An arrival on bar by the threads where arrive is not 0, without a branch.
__device__ __forceinline__ void mbar_arrive_if(uint32_t bar, int arrive) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(bar), "r"(arrive)
      : "memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
// A warpgroup's registers set to N from the launch's kLaunchRegs: setmaxnreg
// may only raise (inc) or lower (dec) the count, so N picks the instruction,
// and N == kLaunchRegs keeps the launch's.
template <int N>
__device__ __forceinline__ void set_regs() {
  static_assert(N % 8 == 0 && N >= 24 && N <= 256, "setmaxnreg takes 24 to 256, a multiple of 8");
  if constexpr (N > kLaunchRegs) setmaxnreg_inc<N>();
  else if constexpr (N < kLaunchRegs) setmaxnreg_dec<N>();
}

// bytes from device memory to shared memory, completing on bar's tx count.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// The descriptor of the B tile at shared address addr: no swizzle, core
// matrices kLbo apart along K and kSbo apart along N.
__device__ __forceinline__ uint64_t tile_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(kLbo >> 4) << 16) | (static_cast<uint64_t>(kSbo >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of the accumulators, or the
// computation of A fragments, across the asynchronous products.
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_a(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int k = 0; k < N; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[k][i])::"memory");
}

// d (the warpgroup's 64 x 128 float32 sums, 64 a thread in the accumulator
// layout above) = A (its 64 x 8 fragment, 4 TF32 words a thread) * B (the
// 8 x 128 tile that desc describes) + (scale_d ? d : 0). Asynchronous: d and
// a are not touched again before wait_group says the group is done.
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], const uint32_t (&a)[4], uint64_t desc,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// A k-step's A fragment halves: big = tf32(x), small = tf32(x - big).
__device__ __forceinline__ void split(uint32_t& big, uint32_t& small, float x) {
  big = tf32_round(x);
  small = tf32_round(__fsub_rn(x, __uint_as_float(big)));
}

// Where the block's tiles are, and how far its walk through the streamed
// ones has gone (the same count in every consumer thread).
struct Tiles {
  uint32_t pinned_base, ring_base, full, empty;
  int pinned;
  uint32_t next;   // streamed tiles acquired so far
};

// The shared address of tile t of the round, once it is there (a streamed
// tile waits for its slot's copy; the pinned ones landed when the block
// entered the sequence); slot: its ring slot, or -1 for a pinned tile.
__device__ __forceinline__ uint32_t acquire(Tiles& w, int t, int& slot) {
  const int streamed = t >= w.pinned;   // then the ring has kRing slots
  const uint32_t n = w.next, sl = n % kRing;
  w.next += streamed;
  slot = streamed ? static_cast<int>(sl) : -1;
  if (streamed) mbar_wait(w.full + 8 * sl, (n / kRing) & 1);
  return streamed ? w.ring_base + sl * kTileBytes
                  : w.pinned_base + static_cast<uint32_t>(t) * kTileBytes;
}

// Lane 0 of each consumer warp gives a ring slot back (nothing for -1).
__device__ __forceinline__ void release(const Tiles& w, int slot) {
  mbar_arrive_if(w.empty + 8 * max(slot, 0), slot >= 0 && (threadIdx.x & 31) == 0);
}

// Layer 0's A fragments of k-step ks, in the row order of
// ops/sdf_mlp.py _wg_rows: lane (g, t) takes angle j = 4 ks + t of rows g
// (xa) and g + 8 (xb), its sine as k-slot t and its cosine as k-slot t + 4
// (one sincosf, sinf's and cosf's arithmetic); past the 3F angles, the three
// coordinates as k-slots t, and zeros.
__device__ __forceinline__ void first_fragments(uint32_t (&ab)[1][4], uint32_t (&as_)[1][4],
                                                const float (&xa)[3], const float (&xb)[3],
                                                const float* __restrict__ freqs, const Shape& s,
                                                int ks) {
  const int j = 4 * ks + (threadIdx.x & 3), angles = 3 * s.n_freqs;
  float a[4] = {0.0f, 0.0f, 0.0f, 0.0f};   // rows g, g + 8 at k-slot t; the same at t + 4
  if (j < angles) {
    const int axis = j / s.n_freqs;
    const float f = __ldg(freqs + (j - axis * s.n_freqs));
    sincosf(__fmul_rn(pick3(xa, axis), f), &a[0], &a[2]);
    sincosf(__fmul_rn(pick3(xb, axis), f), &a[1], &a[3]);
  } else if (j < angles + 3) {
    a[0] = pick3(xa, j - angles);
    a[1] = pick3(xb, j - angles);
  }
  __syncwarp();   // the features branch by lane
#pragma unroll
  for (int i = 0; i < 4; ++i) split(ab[0][i], as_[0][i], a[i]);
}

// Layer 0's products of k-step ks on fragments ab / as_ (its tiles are
// pinned): big*big into dm, small*big + big*small into dc; meanwhile the
// fragments of k-step ks + 1 are computed into nb / ns.
__device__ __forceinline__ void first_step(float (&dm)[64], float (&dc)[64], uint32_t (&ab)[1][4],
                                           uint32_t (&as_)[1][4], uint32_t (&nb)[1][4],
                                           uint32_t (&ns)[1][4], const float (&xa)[3],
                                           const float (&xb)[3], const float* __restrict__ freqs,
                                           const Shape& s, const Tiles& w, int ks) {
  fence_a(ab);
  fence_a(as_);
  fence_acc(dm);
  fence_acc(dc);
  wgmma_fence();
  const uint32_t at = w.pinned_base + static_cast<uint32_t>(2 * ks) * kTileBytes;
  const uint64_t big = tile_desc(at), small = tile_desc(at + kTileBytes);
  wgmma_tf32(dc, as_[0], big, ks > 0);
  wgmma_tf32(dc, ab[0], small, 1);
  wgmma_tf32(dm, ab[0], big, ks > 0);
  wgmma_commit();
  first_fragments(nb, ns, xa, xb, freqs, s, ks + 1);
  wgmma_wait<0>();
  fence_acc(dm);
  fence_acc(dc);
  fence_a(ab);   // the products read ab and as_ until here
  fence_a(as_);
}

// Layer 0 for the warpgroup, one k-step at a time, the next k-step's
// features computed while the products of this one run (two sets of
// fragments, taken in turns); dm and dc are overwritten.
__device__ __forceinline__ void first_layer(float (&dm)[64], float (&dc)[64],
                                            const float (&xa)[3], const float (&xb)[3],
                                            const float* __restrict__ freqs, const Shape& s,
                                            const Tiles& w) {
  uint32_t ab[1][4], as_[1][4], nb[1][4], ns[1][4];
  first_fragments(ab, as_, xa, xb, freqs, s, 0);
  for (int ks = 0; ks < s.ks0; ks += 2) {
    first_step(dm, dc, ab, as_, nb, ns, xa, xb, freqs, s, w, ks);
    if (ks + 1 == s.ks0) break;
    first_step(dm, dc, nb, ns, ab, as_, xa, xb, freqs, s, w, ks + 1);
  }
}

// A later layer's products for the warpgroup: act holds the previous
// layer's outputs (bias and ReLU applied) in accumulator order, which is this
// layer's A-fragment order (_wg_rows' order): units 8 ks + 2 t and + 1 of
// rows g and g + 8 are k-slots t and t + 4 of k-step ks. Each k-step's
// fragments are split while the one before runs (two sets, in turns), its
// products go into dm (big*big) and dc (small*big + big*small), a group a
// k-step; once the next is issued, the one before is done and its ring slots
// go back. dm and dc are overwritten.
__device__ __forceinline__ void hidden_layer(float (&dm)[64], float (&dc)[64],
                                             const float (&act)[64], int first_tile, Tiles& w) {
  uint32_t ab[2][1][4], as_[2][1][4];
  int held_b = -1, held_s = -1;   // the previous k-step's ring slots
#pragma unroll
  for (int ks = 0; ks < kMaxKSteps; ++ks) {
    uint32_t (&b)[1][4] = ab[ks & 1];
    uint32_t (&sm)[1][4] = as_[ks & 1];
    split(b[0][0], sm[0][0], act[4 * ks]);
    split(b[0][1], sm[0][1], act[4 * ks + 2]);
    split(b[0][2], sm[0][2], act[4 * ks + 1]);
    split(b[0][3], sm[0][3], act[4 * ks + 3]);
    int slot_b, slot_s;
    const uint64_t big = tile_desc(acquire(w, first_tile + 2 * ks, slot_b));
    const uint64_t small = tile_desc(acquire(w, first_tile + 2 * ks + 1, slot_s));
    // the waits above branch by thread: the products after them need their
    // own fence, or the compiler inserts one and serialises them
    fence_a(b);
    fence_a(sm);
    fence_acc(dm);
    fence_acc(dc);
    wgmma_fence();
    wgmma_tf32(dc, sm[0], big, ks > 0);
    wgmma_tf32(dc, b[0], small, 1);
    wgmma_tf32(dm, b[0], big, ks > 0);
    wgmma_commit();
    wgmma_wait<1>();
    if (ks > 0) {   // the previous k-step's fragments were read until here
      fence_a(ab[(ks - 1) & 1]);
      fence_a(as_[(ks - 1) & 1]);
    }
    release(w, held_b);
    release(w, held_s);
    held_b = slot_b;
    held_s = slot_s;
  }
  wgmma_wait<0>();
  fence_acc(dm);
  fence_acc(dc);
  fence_a(ab[1]);
  fence_a(as_[1]);
  release(w, held_b);
  release(w, held_s);
}

// A layer's outputs from its two sums: ReLU((dm + dc) + bias) in accumulator
// order (units 8 j + 2 t and + 1 of rows g and g + 8).
__device__ __forceinline__ void bias_relu(float (&act)[64], const float (&dm)[64],
                                          const float (&dc)[64], const float* __restrict__ bias,
                                          int t) {
#pragma unroll
  for (int j = 0; j < kMaxKSteps; ++j) {
    const float2 b = __ldg(reinterpret_cast<const float2*>(bias + 8 * j + 2 * t));
    act[4 * j] = fmaxf(__fadd_rn(dm[4 * j], dc[4 * j]) + b.x, 0.0f);
    act[4 * j + 1] = fmaxf(__fadd_rn(dm[4 * j + 1], dc[4 * j + 1]) + b.y, 0.0f);
    act[4 * j + 2] = fmaxf(__fadd_rn(dm[4 * j + 2], dc[4 * j + 2]) + b.x, 0.0f);
    act[4 * j + 3] = fmaxf(__fadd_rn(dm[4 * j + 3], dc[4 * j + 3]) + b.y, 0.0f);
  }
}

// ---- bf16 ----

// lo and hi rounded to bf16 (to nearest, ties to even) in one 32-bit word,
// lo in the low half: the A-fragment register of two k-slots.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}

// The low (lo) and the high (hi) bf16 of a pack_bf16 word, as float32: the
// bits of pack_bf16(x, 0) << 16, x rounded to bf16, two to a conversion.
__device__ __forceinline__ float bf16_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t v) { return __uint_as_float(v & 0xFFFF0000u); }

// d (64 x 128 float32 sums) = A (64 x 16 bf16, 4 words a thread) * B (the
// 16 x 128 bf16 tile that desc describes, K-major) + (scale_d ? d : 0).
// Asynchronous, as wgmma_tf32.
__device__ __forceinline__ void wgmma_bf16(float (&d)[64], const uint32_t (&a)[4], uint64_t desc,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// Layer 0's bf16 A fragment of k-step ks, in the row order of ops/sdf_mlp.py
// _wg16_rows: lane (g, t) takes angle 8 ks + t as k-slots 2 t (sine) and
// 2 t + 1 (cosine) and angle 8 ks + 4 + t as k-slots 2 t + 8 and 2 t + 9, of
// rows g (xa) and g + 8 (xb), one sincosf each; past the 3F angles, the three
// coordinates as the first k-slot of a pair, and zeros (the model's
// frequencies in shared memory or device memory).
__device__ __forceinline__ void first_fragments16(uint32_t (&a)[4], const float (&xa)[3],
                                                  const float (&xb)[3],
                                                  const float* __restrict__ freqs,
                                                  const Shape& s, int ks) {
  const int angles = 3 * s.n_freqs;
  float v[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};   // [pair][row][sin, cos]
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int j = 8 * ks + 4 * h + (threadIdx.x & 3);
    if (j < angles) {
      const int axis = (j >= s.n_freqs) + (j >= 2 * s.n_freqs);   // j / F, without a division
      const float f = freqs[j - axis * s.n_freqs];
      sincosf(__fmul_rn(pick3(xa, axis), f), &v[4 * h], &v[4 * h + 1]);
      sincosf(__fmul_rn(pick3(xb, axis), f), &v[4 * h + 2], &v[4 * h + 3]);
    } else if (j < angles + 3) {
      v[4 * h] = pick3(xa, j - angles);
      v[4 * h + 2] = pick3(xb, j - angles);
    }
  }
  __syncwarp();   // the features branch by lane
#pragma unroll
  for (int i = 0; i < 4; ++i) a[i] = pack_bf16(v[2 * i], v[2 * i + 1]);
}

// Layer 0's bf16 products of k-step ks on fragment f[0] and, where the layer
// has it, of k-step ks + 1 on f[1] (their tiles are pinned): a group each, no
// wait.
__device__ __forceinline__ void first_pair16(float (&d)[64], uint32_t (&f)[2][4], const Shape& s,
                                             const Tiles& w, int ks) {
  fence_a(f);
  fence_acc(d);
  wgmma_fence();
  wgmma_bf16(d, f[0], tile_desc(w.pinned_base + static_cast<uint32_t>(ks) * kTileBytes), ks > 0);
  wgmma_commit();
  if (ks + 1 < s.ks0) {
    fence_a(f);
    fence_acc(d);
    wgmma_fence();
    wgmma_bf16(d, f[1], tile_desc(w.pinned_base + static_cast<uint32_t>(ks + 1) * kTileBytes), 1);
    wgmma_commit();
  }
}

// Layer 0 in bf16 for the warpgroup: a pair of k-steps' fragments computed
// (the shipped net's two k-steps are one pair), then their products issued
// back to back, and one wait at the end; a later pair (more than three
// frequencies) waits for the one before. d is overwritten.
__device__ __forceinline__ void first_layer16(float (&d)[64], const float (&xa)[3],
                                              const float (&xb)[3],
                                              const float* __restrict__ freqs, const Shape& s,
                                              const Tiles& w) {
  uint32_t f[2][4];
  for (int ks = 0; ks < s.ks0; ks += 2) {
    if (ks > 0) {   // the pair before reads f until here
      wgmma_wait<0>();
      fence_a(f);
    }
    first_fragments16(f[0], xa, xb, freqs, s, ks);
    first_fragments16(f[1], xa, xb, freqs, s, ks + 1);
    first_pair16(d, f, s, w, ks);
  }
  wgmma_wait<0>();
  fence_acc(d);
  fence_a(f);
}

// A layer's bf16 A fragments from its sums: ReLU(d + bias) of n-tiles 2 ks
// and 2 ks + 1 is k-step ks's fragment (units 16 ks + 2 t, + 1 and
// 16 ks + 8 + 2 t, + 1 of rows g and g + 8).
__device__ __forceinline__ void bias_relu16(uint32_t (&a)[kMaxKSteps / 2][4],
                                            const float (&d)[64],
                                            const float* __restrict__ bias, int t) {
  const float2* __restrict__ bt = reinterpret_cast<const float2*>(bias + 2 * t);
#pragma unroll
  for (int j = 0; j < kMaxKSteps; ++j) {
    const float2 b = bt[4 * j];
    a[j / 2][2 * (j & 1)] = pack_bf16(fmaxf(d[4 * j] + b.x, 0.0f),
                                      fmaxf(d[4 * j + 1] + b.y, 0.0f));
    a[j / 2][2 * (j & 1) + 1] = pack_bf16(fmaxf(d[4 * j + 2] + b.x, 0.0f),
                                          fmaxf(d[4 * j + 3] + b.y, 0.0f));
  }
}

// A later layer's bf16 products for the warpgroup on the fragments a of the
// layer before, tile first_tile + ks for k-step ks. A layer whose tiles are
// all pinned (every layer of a net of up to 18 tiles) issues its eight
// products back to back as one group and waits once; a layer with streamed
// tiles takes each from the ring, a group a k-step, and once the next is
// issued the one before is done and its ring slot goes back. d is
// overwritten.
__device__ __forceinline__ void hidden_layer16(float (&d)[64],
                                               uint32_t (&a)[kMaxKSteps / 2][4],
                                               int first_tile, Tiles& w) {
  int held = -1;   // the previous k-step's ring slot
  if (first_tile + kMaxKSteps / 2 <= w.pinned) {
    // a tile kTileBytes further on: its descriptor kTileBytes / 16 further on
    const uint64_t desc = tile_desc(w.pinned_base + static_cast<uint32_t>(first_tile) * kTileBytes);
    fence_a(a);
    fence_acc(d);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kMaxKSteps / 2; ++ks)
      wgmma_bf16(d, a[ks], desc + static_cast<uint64_t>(ks) * (kTileBytes >> 4), ks > 0);
    wgmma_commit();
  } else {
#pragma unroll
    for (int ks = 0; ks < kMaxKSteps / 2; ++ks) {
      int slot;
      const uint64_t desc = tile_desc(acquire(w, first_tile + ks, slot));
      // the wait above branches by thread: the product after it needs its own
      // fence, or the compiler inserts one and serialises the products
      fence_a(a);
      fence_acc(d);
      wgmma_fence();
      wgmma_bf16(d, a[ks], desc, ks > 0);
      wgmma_commit();
      wgmma_wait<1>();
      release(w, held);
      held = slot;
    }
  }
  wgmma_wait<0>();
  fence_acc(d);
  fence_a(a);
  release(w, held);
}

// The model's parts: in device memory, or (bf16) the head in shared memory.
struct Net {
  float scale, clamp;
  const float* freqs;
  const float* bias;    // 128 a hidden layer
  const float* wout;    // output weights [128], then the bias
  const float* tiles;
};

__device__ __forceinline__ Net net_of(const float* __restrict__ packed, const Shape& s) {
  Net n;
  n.scale = __ldg(packed);
  n.clamp = __ldg(packed + 1);
  n.freqs = packed + 4;
  n.bias = packed + header_floats(s);
  n.wout = n.bias + kUnits * s.n_hidden;
  n.tiles = packed + tiles_offset(s);
  return n;
}

// The head of a model copied to shared memory (bf16; its tiles apart).
__device__ __forceinline__ Net net_in(const float* head, const Shape& s) {
  Net n;
  n.scale = head[0];
  n.clamp = head[1];
  n.freqs = head + 4;
  n.bias = head + header_floats(s);
  n.wout = n.bias + kUnits * s.n_hidden;
  n.tiles = nullptr;
  return n;
}

// The clamped sdf of the warp's rows g (xa, scaled coordinates) and g + 8
// (xb), returned to every lane of the row's four. Every thread of the
// consumer warpgroup calls it.
__device__ __forceinline__ float2 mlp_rows(const float (&xa)[3], const float (&xb)[3],
                                           const Net& net, const Shape& s, Tiles& w) {
  const int t = threadIdx.x & 3;
  float dm[64], dc[64], act[64];
  first_layer(dm, dc, xa, xb, net.freqs, s, w);
  for (int l = 1; l < s.n_hidden; ++l) {
    bias_relu(act, dm, dc, net.bias + kUnits * (l - 1), t);
    hidden_layer(dm, dc, act, 2 * (s.ks0 + kMaxKSteps * (l - 1)), w);
  }
  bias_relu(act, dm, dc, net.bias + kUnits * (s.n_hidden - 1), t);
  float p0 = 0.0f, p1 = 0.0f;
#pragma unroll
  for (int j = 0; j < kMaxKSteps; ++j) {
    const float2 wo = __ldg(reinterpret_cast<const float2*>(net.wout + 8 * j + 2 * t));
    p0 = fmaf(act[4 * j], wo.x, p0);
    p0 = fmaf(act[4 * j + 1], wo.y, p0);
    p1 = fmaf(act[4 * j + 2], wo.x, p1);
    p1 = fmaf(act[4 * j + 3], wo.y, p1);
  }
  p0 += __shfl_xor_sync(0xffffffffu, p0, 1);
  p1 += __shfl_xor_sync(0xffffffffu, p1, 1);
  p0 += __shfl_xor_sync(0xffffffffu, p0, 2);
  p1 += __shfl_xor_sync(0xffffffffu, p1, 2);
  const float b = __ldg(net.wout + kUnits);
  return make_float2(fminf(fmaxf(p0 + b, -net.clamp), net.clamp),
                     fminf(fmaxf(p1 + b, -net.clamp), net.clamp));
}

// mlp_rows in bf16: the same rows, one accumulator, the output layer in
// float32 FMA on bf16-rounded activations and weights (the packed output
// weights are rounded already; the activations two to a conversion).
__device__ __forceinline__ float2 mlp_rows16(const float (&xa)[3], const float (&xb)[3],
                                             const Net& net, const Shape& s, Tiles& w) {
  const int t = threadIdx.x & 3;
  float d[64];
  uint32_t a[kMaxKSteps / 2][4];
  first_layer16(d, xa, xb, net.freqs, s, w);
  for (int l = 1; l < s.n_hidden; ++l) {
    bias_relu16(a, d, net.bias + kUnits * (l - 1), t);
    hidden_layer16(d, a, s.first_tiles + kMaxKSteps / 2 * (l - 1), w);
  }
  const float2* __restrict__ bt =
      reinterpret_cast<const float2*>(net.bias + kUnits * (s.n_hidden - 1) + 2 * t);
  const float2* __restrict__ wt = reinterpret_cast<const float2*>(net.wout + 2 * t);
  float p0 = 0.0f, p1 = 0.0f;
#pragma unroll
  for (int j = 0; j < kMaxKSteps; ++j) {
    const float2 b = bt[4 * j], wo = wt[4 * j];
    // units 8 j + 2 t and + 1 of rows g (r0) and g + 8 (r1)
    const uint32_t r0 = pack_bf16(fmaxf(d[4 * j] + b.x, 0.0f), fmaxf(d[4 * j + 1] + b.y, 0.0f));
    const uint32_t r1 =
        pack_bf16(fmaxf(d[4 * j + 2] + b.x, 0.0f), fmaxf(d[4 * j + 3] + b.y, 0.0f));
    p0 = fmaf(bf16_lo(r0), wo.x, p0);
    p0 = fmaf(bf16_hi(r0), wo.y, p0);
    p1 = fmaf(bf16_lo(r1), wo.x, p1);
    p1 = fmaf(bf16_hi(r1), wo.y, p1);
  }
  p0 += __shfl_xor_sync(0xffffffffu, p0, 1);
  p1 += __shfl_xor_sync(0xffffffffu, p1, 1);
  p0 += __shfl_xor_sync(0xffffffffu, p0, 2);
  p1 += __shfl_xor_sync(0xffffffffu, p1, 2);
  const float b = net.wout[kUnits];
  return make_float2(fminf(fmaxf(p0 + b, -net.clamp), net.clamp),
                     fminf(fmaxf(p1 + b, -net.clamp), net.clamp));
}

// A float of a per-round input (a frame, a pose), loaded where it is used: a
// volatile load is neither hoisted out of the walk's loop nor kept in a
// register across the MLP.
__device__ __forceinline__ float frame_at(const float* p) {
  float v;
  asm volatile("ld.global.nc.f32 %0, [%1];\n" : "=f"(v) : "l"(p));
  return v;
}

// What a kernel on the walk says besides its point reader and round store:
// the defaults, which #3 and #6 keep (every hook below is empty for them, and
// the walk compiles it away). A job derives from Job and overrides what it
// uses:
//   kGroups, span()                   rounds of a group: the block walks groups
//                                     b, b + grid, ..., a group's rounds in
//                                     ascending order (without kGroups every
//                                     round is a group: items b, b + grid, ...);
//   kSums                             each round's values summed (`add`, then
//                                     `total` after a group's last round)
//                                     instead of stored;
//   kStage                            slots of a staged-input handshake: the
//                                     aside warps `build` a round's inputs into
//                                     a slot of shared memory up to kStage
//                                     rounds ahead, the consumers `take` them
//                                     where the round starts (a full and an
//                                     empty mbarrier a slot); 0: `load` a round
//                                     ahead and `place`, and `aside` beside;
//   kConsumerRegs, kProducerRegs      the setmaxnreg split, 2 x 128 x consumer
//                                     + 128 x producer <= 64,512 (kLaunchRegs
//                                     both: the launch's, no setmaxnreg);
//   scratch_bytes()                   shared memory the job uses after the
//                                     walk's (its stage's barriers apart).
struct Job {
  static constexpr bool kGroups = false;
  static constexpr bool kSums = false;
  static constexpr int kStage = 0;
  static constexpr int kConsumerRegs = 232;
  static constexpr int kProducerRegs = 40;
  __host__ __device__ long long span() const { return 1; }
  __host__ long long scratch_bytes() const { return 0; }
  __device__ void load(long long, long long, float (&)[3]) const {}
  __device__ void place(long long, long long, const float (&)[3], float, float (&)[3]) const {}
  __device__ void store(long long, long long, float) const {}
  __device__ void aside(long long, long long, int) const {}
  __device__ void build(long long, long long, int, int, unsigned char*) const {}
  __device__ void take(long long, long long, int, const unsigned char*, float,
                       float (&)[3]) const {}
  __device__ void add(float&, long long, float2) const {}
  __device__ void total(float&, long long, unsigned char*, int) const {}
};

// Bytes of a job's stage barriers, a full and an empty one a slot.
template <class J>
__host__ __device__ constexpr int stage_barrier_bytes() { return (16 * J::kStage + 15) & ~15; }

// The shared memory a job adds to the walk's.
template <class J>
inline long long job_bytes(const J& job) { return stage_barrier_bytes<J>() + job.scratch_bytes(); }

// The persistent walk of a kernel on this core, for one block of kThreads
// threads with `smem` holding smem_bytes(pinned, ring) + shape.head +
// job_bytes(job) bytes: items = rounds x sequences, item i is round i % rounds
// of sequence i / rounds, whose model lies s * packed_seq floats into `packed`
// (wg layout); items is a multiple of job.span(). A Job says how the kernel
// reads a point and stores a round:
//   long long m                       points a sequence;
//   load(s, row, raw[3])              the point's raw values, issued a round
//                                     ahead (anything finite past m);
//   place(s, row, raw, scale, x[3])   the MLP's scaled input, when its round
//                                     starts (no loads in flight behind it);
//   store(s, row, sdf)                the clamped sdf of a row < m, by lane
//                                     row % 16 of the warp that holds it;
//   aside(s, round, t)                warps 9-11's work for the item, thread
//                                     t of kAsideThreads, beside the copies;
// or, staged (kStage > 0), instead of load, place and aside:
//   build(s, round, t, slot, scratch) warps 9-11 fill stage slot `slot` with
//                                     the round's inputs (the walk waits for
//                                     the slot to be free and says when it is
//                                     full; the scratch's first int is -1
//                                     before the first build);
//   take(s, row, slot, scratch, scale, x[3])  the MLP's input from the slot;
// and, summing (kSums), instead of store:
//   add(sum, row, sdf)                every consumer thread after each round:
//                                     sdf.x of its row g, sdf.y of g + 8;
//   total(sum, group, scratch, parity)  every consumer thread after its
//                                     group's last round (parity: the block's
//                                     groups so far, mod 2).
// A point's value depends on its raw values and its model only. kBf16: the
// MLP in bf16 (mlp_rows16, the wg16 layout), else in 3xTF32.
template <bool kBf16, class J>
__device__ __forceinline__ void walk(const J& job, unsigned char* smem,
                                     const float* __restrict__ packed, long long packed_seq,
                                     long long rounds, long long items, const Shape& shape,
                                     int pinned, int ring) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  Tiles w;
  w.pinned_base = smem_addr(smem);
  w.ring_base = w.pinned_base + static_cast<uint32_t>(pinned) * kTileBytes;
  w.full = w.ring_base + static_cast<uint32_t>(ring) * kTileBytes;
  w.empty = w.full + 8 * ring;
  w.pinned = pinned;
  w.next = 0;
  const uint32_t pin = w.empty + 8 * ring;   // the pinned tiles' (and the head's) copy
  // bf16: the model's head (scale, clamp, frequencies, biases, output layer),
  // which every round reads, in shared memory beside the tiles: in device
  // memory it misses L1 behind the streamed points (3xTF32 reads it there)
  float* head = reinterpret_cast<float*>(smem + smem_bytes(pinned, ring));
  const int head_bytes = kBf16 ? shape.head : 0;
  // the job's shared memory: its stage's barriers, then its scratch
  unsigned char* job_smem = smem + smem_bytes(pinned, ring) + head_bytes;
  const uint32_t stage_full = smem_addr(job_smem), stage_empty = stage_full + 8 * J::kStage;
  unsigned char* scratch = job_smem + stage_barrier_bytes<J>();
  if (threadIdx.x == 0) {
    for (int i = 0; i < ring; ++i) {
      mbar_init(w.full + 8 * i, 1);
      mbar_init(w.empty + 8 * i, kConsumerWarps);
    }
    mbar_init(pin, 1);
    for (int i = 0; i < J::kStage; ++i) {
      mbar_init(stage_full + 8 * i, kAsideThreads);
      mbar_init(stage_empty + 8 * i, kConsumerWarps);
    }
    if constexpr (J::kStage > 0) *reinterpret_cast<int*>(scratch) = -1;
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the block's items: the rounds of groups b, b + grid, ... in ascending order
  const long long span = J::kGroups ? job.span() : 1;
  // read in each warpgroup's branch (a value live across setmaxnreg moves
  // ptxas's register allocation)
  const auto first = [&]() -> long long {
    return J::kGroups ? static_cast<long long>(blockIdx.x) * span : blockIdx.x;
  };
  const auto after = [&](long long item) {
    if constexpr (!J::kGroups) return item + gridDim.x;
    return (item + 1) % span != 0 ? item + 1
                                  : item + 1 + (static_cast<long long>(gridDim.x) - 1) * span;
  };
  // an item's sequence; in bf16 in 32 bits where every item fits in them (a
  // 64-bit division costs several times the instructions, a few times a round)
  const auto seq_of = [&](long long item) -> long long {
    if constexpr (kBf16) {
      if (items <= 0xFFFFFFFFLL)
        return static_cast<unsigned>(item) / static_cast<unsigned>(rounds);
    }
    return item / rounds;
  };
  long long loaded = -1;
  if (warp >= kConsumerWarps) {   // the producer's warpgroup
    set_regs<J::kProducerRegs>();
    const bool copies = warp == kProducerWarp;   // the other three do the job's aside
    uint32_t built = 0;   // stage slots filled so far
    for (long long item = first(); item < items; item = after(item)) {
      const long long s = seq_of(item);
      const float* tiles = packed + s * packed_seq + tiles_offset(shape);
      if (s != loaded) {   // the consumers are done with the previous model's tiles
        __syncthreads();
        loaded = s;
        if (copies) {
          if (lane == 0)
            mbar_expect_tx(pin, static_cast<uint32_t>(pinned) * kTileBytes + head_bytes);
          __syncwarp();
          for (int t = lane; t < pinned; t += 32)
            bulk_copy(w.pinned_base + static_cast<uint32_t>(t) * kTileBytes,
                      tiles + static_cast<long long>(t) * kTileFloats, kTileBytes, pin);
          if (head_bytes > 0 && lane == 0)
            bulk_copy(smem_addr(head), packed + s * packed_seq, head_bytes, pin);
        }
      }
      if (!copies) {
        const int t = static_cast<int>(threadIdx.x) - 32 * (kProducerWarp + 1);
        if constexpr (J::kStage > 0) {
          const uint32_t n = built++, slot = n % J::kStage;
          mbar_wait(stage_empty + 8 * slot, ((n / J::kStage) & 1) ^ 1);
          job.build(s, item - s * rounds, t, static_cast<int>(slot), scratch);
          mbar_arrive_if(stage_full + 8 * slot, 1);
        } else {
          job.aside(s, item - s * rounds, t);
        }
        continue;
      }
      for (int t = pinned; t < shape.tiles; ++t) {
        const uint32_t n = w.next++;   // streaming, the ring has kRing slots
        const uint32_t slot = n % kRing;
        mbar_wait(w.empty + 8 * slot, ((n / kRing) & 1) ^ 1);
        if (lane == 0) {
          mbar_expect_tx(w.full + 8 * slot, kTileBytes);
          bulk_copy(w.ring_base + slot * kTileBytes,
                    tiles + static_cast<long long>(t) * kTileFloats, kTileBytes,
                    w.full + 8 * slot);
        }
        __syncwarp();
      }
    }
    return;
  }

  set_regs<J::kConsumerRegs>();
  const int g = lane >> 2;
  uint32_t reloads = 0, taken = 0;
  float sum = 0.0f;   // kSums: the thread's part of its group's sum
  int groups = 0;
  // the rows' points of the walk's next item are read a round ahead
  float na[3], nb[3];
  const auto fetch = [&](long long item) {
    if constexpr (J::kStage == 0) {
      const long long s = seq_of(item);
      const long long row = (item - s * rounds) * kRoundPoints + warp * 16 + g;
      job.load(s, row, na);
      job.load(s, row + 8, nb);
    }
  };
  if (first() < items) fetch(first());
  for (long long item = first(); item < items; item = after(item)) {
    const long long s = seq_of(item);
    Net net = net_of(packed + s * packed_seq, shape);
    if (s != loaded) {
      __syncthreads();
      mbar_wait(pin, reloads++ & 1);
      loaded = s;
    }
    if constexpr (kBf16) net = net_in(head, shape);   // once the copy has landed
    float xa[3], xb[3];
    const long long row = (item - s * rounds) * kRoundPoints + warp * 16 + g;
    if constexpr (J::kStage > 0) {
      const uint32_t n = taken++, slot = n % J::kStage;
      mbar_wait(stage_full + 8 * slot, (n / J::kStage) & 1);
      job.take(s, row, static_cast<int>(slot), scratch, net.scale, xa);
      job.take(s, row + 8, static_cast<int>(slot), scratch, net.scale, xb);
      __syncwarp();   // the warp's reads of the slot are done
      mbar_arrive_if(stage_empty + 8 * slot, lane == 0);
    } else {
      job.place(s, row, na, net.scale, xa);
      job.place(s, row + 8, nb, net.scale, xb);
      const long long next = after(item);
      if (next < items) fetch(next);
    }
    float2 sdf;
    if constexpr (kBf16) sdf = mlp_rows16(xa, xb, net, shape, w);
    else sdf = mlp_rows(xa, xb, net, shape, w);
    if constexpr (J::kSums) {
      job.add(sum, row, sdf);
      if ((item + 1) % span == 0) job.total(sum, item / span, scratch, groups++ & 1);
    } else {
      // lane l < 16 stores the warp's row l, which lanes 4 (l % 8) .. + 3 hold
      const long long base = (item - s * rounds) * kRoundPoints + warp * 16;
      const float lo = __shfl_sync(0xffffffffu, sdf.x, 4 * (lane & 7));
      const float hi = __shfl_sync(0xffffffffu, sdf.y, 4 * (lane & 7));
      if (lane < 16 && base + lane < job.m) job.store(s, base + lane, lane < 8 ? lo : hi);
    }
  }
}

// A named barrier of the consumer warpgroups (warps 0-7), apart from the
// block's barrier 0.
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(32 * kConsumerWarps) : "memory");
}
// The same for the aside warps (9-11).
__device__ __forceinline__ void aside_sync() {
  asm volatile("bar.sync 2, %0;\n" ::"n"(kAsideThreads) : "memory");
}

// Host side of a launch on this core.

// Opts `kernel` into as much dynamic shared memory as a block may have on the
// current device (into `limit`).
template <class Kernel>
inline cudaError_t opt_in(Kernel* kernel, int& limit) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, limit);
}

// A kernel's persistent grid: blocks that fit at once, remembered for the
// shared-memory size they were counted at.
struct Grid {
  long long smem = -1;
  int blocks = 0;
};

// Pinned tiles, ring slots, shared memory and grid for `items` groups of
// rounds of a model of `shape` within `limit` bytes a block, `extra` of them
// the job's (job_bytes).
template <class Kernel>
inline cudaError_t plan_launch(Kernel* kernel, const Shape& shape, int limit, long long items,
                               Grid& grid_of, int& pinned, int& ring, long long& smem,
                               unsigned& grid, long long extra = 0) {
  plan(shape, limit - extra, pinned, ring);
  if (pinned < 0) return cudaErrorInvalidValue;
  smem = smem_bytes(pinned, ring) + shape.head + extra;
  if (smem != grid_of.smem) {
    int device = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                          static_cast<size_t>(smem));
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    grid_of.smem = smem;
    grid_of.blocks = sms * per_sm;
  }
  grid = static_cast<unsigned>(items < grid_of.blocks ? items : grid_of.blocks);
  return cudaSuccess;
}

}  // namespace wg
}  // namespace hotrack
