// MANO skinning fused with the per-vertex hand energy for Hopper (sm_90a).
//
// Replaces the TPU kernels of hotrack_tpu/ops/pallas/hand_energy_skin.py:
// _skin_energy_kernel, reached through _skin_impl from
// fused_hand_energy_skin, and its per-sequence form _skin_energy_kernel_b,
// reached through _skin_impl_batched when several sequences are tracked, each
// with its shape, object pose, mask and model: per candidate p and vertex v
//   vp_c  = v_shaped[c][v] + sum_k posedirs[c][k][v] * pose_map[p][k]
//   s_r   = sum_j rt[p][r][j] * weights[j][v]        r = 0..11: R (9) then t (3)
//   x_c   = ((s_3c vp_0 + s_3c+1 vp_1 + s_3c+2 vp_2) + s_9+c) + offset[p][c]
//   sdf, hit = the per-vertex energy of hand_energy.cu at x
// which is the linear blend skinning of mano_forward followed by
// fused_hand_energy. Inputs: per candidate pose_map (P, K), rt (P, 12, 16)
// (rt_flat of mano/layer.py mano_skin_inputs), offset (P, 3); per call,
// vertex-minor, posedirs (3, K, N), v_shaped (3, N), weights (16, N). Not
// carried over from the TPU: vertices padded to a lane multiple, the particle
// tile with its role-major slab and sub-tiles, P padded by repeating
// particle 0.
//
// Bound: operations. A vertex costs the MLP's 71,168 operations, three
// tensor-core passes of them in 3xTF32 at 495 TFLOP/s, plus 1,239 float32
// operations at 67 TFLOP/s: 2 (3 K + 12 * 16) + 18 = 1,212 of skinning at
// K = 135 and 27 of transform and projection. At 5120 x 778 vertices that is
// 1.792 ms (4.305 ms with the MLP in float32 FMA); the inputs are 1.35 KB a
// candidate and 1.3 MB a call, the outputs 8 bytes a vertex.
// Precision: the skinning is float32 FMA with float32 accumulation, sums in
// ascending k and j from 0 in the order written above, in both precisions, so
// the two build bitwise the same vertices and hits; the transform into the
// object's frame and the projection as in hand_energy_core.cuh.
//
// 3xTF32, entry hotrack_hand_energy_skin: two kernels, one after the other
// in the stream. (1) The skinning pre-pass (skin_vertices_kernel): a block of
// 256 threads takes 32 vertices by 32 candidates of one sequence, stages the
// candidates' inputs (transposed: entry e of candidate c at 32 e + c) and the
// vertices' columns of posedirs, v_shaped and weights in shared memory (96,640
// bytes at K = 135), and thread (warp w, lane j) builds vertex j for
// candidates 4 w .. 4 w + 3 (a posedirs value loaded once for four
// candidates, a pose_map entry a broadcast), writes it to a (S, P, N, 3)
// scratch that the wrapper allocates (47.8 MB at 5120 x 778) and stores its
// hit. So in this precision the vertices do reach device memory: about 0.03
// ms of HBM each way at 3.35 TB/s. (2) The walk of sdf_mlp_wgmma.cuh in
// 3xTF32 (wg::walk<false>, wgmma m64n128k8 TF32 from PackedSDF.wg, 48 of the
// 70 tiles of 21-128-128-128-1 pinned, two consumer warpgroups at 232
// registers and the producer's at 40, as #3 and #6): row r of a sequence is
// the pre-pass's vertex r (candidate r / N, vertex r % N), 128 a round; a
// consumer reads a row's vertex a round ahead, moves it into the object's
// frame, scaled, where the round starts, as hand_energy.cu's `place` does,
// and stores the sdf. So the sdf is bitwise #6's on the same vertices and
// frame, and the hit bitwise #6's too. Why not the bf16 design below (the
// skinning on the aside warps, off the consumers' path): beside the 3xTF32
// consumers the stage leaves room for 33 of the 70 tiles, and setmaxnreg
// leaves the aside warps 40 registers, where this skinning spilled at
// 56-72 (PERF.md, section 6). No atomics; nothing depends on the grid or on
// the block that took a row, so two launches agree bitwise. Sequences: the
// per-candidate inputs and the outputs are (S, P, ...); each per-call input
// (posedirs, v_shaped, weights, frame, mask, packed model) lies s times its
// own stride further on, and a stride of 0 shares it between the sequences
// (posedirs and weights always are). An unbatched launch is the case of one
// sequence: sequence s of a batched launch computes bitwise what an unbatched
// launch on s's inputs computes.
//
// bf16 (HOTRACK_SDF_BF16), entry hotrack_hand_energy_skin_bf16: a job on the
// persistent bf16 wgmma walk of sdf_mlp_wgmma.cuh (wg::walk<true>, wgmma
// m64n128k16, PackedSDF.wg16), with the skinning off the consumers' path and
// the vertices never in device memory. Rows: a round of 128 is a tile of 32
// vertices by a quad of 4 candidates, rounds tile-major, and row 4 j + c of a
// round is candidate 4 quad + c's vertex 32 tile + j (rows past N or P are
// padding: 2.8% at N = 778, none past P at P = 5120). The producer
// warpgroup's three aside warps build each round's camera-frame vertices into
// a stage of shared memory (kStage slots, up to two rounds ahead of the
// consumers, a full and an empty mbarrier a slot, the walk's staged-input
// handshake): warp 9 + c, lane j computes coordinate c of vertex 32 tile + j
// for the quad's four candidates from the quad's per-candidate inputs
// (pose_map, rt, offset), staged in shared memory for the round, and the
// tile's columns of posedirs, v_shaped and weights, staged when a block's
// round moves to another tile or sequence (a block's rounds b, b + 132, ...
// stay on one tile for about quads / 132 of them: a posedirs value is loaded
// once for four candidates and for about ten rounds); the three warps swap vp
// through shared memory, each finishes coordinate c of x, then they look up
// the round's hits. The staged inputs arrive by cp.async. The consumers take a
// row's vertex from the stage and move it into the object's frame, scaled, as
// hand_energy.cu's `place` does, and store the sdf. Registers: the launch's
// 168 for every warp (no setmaxnreg: the aside's sums need room to issue their
// shared-memory loads ahead of the FMAs; at 72 ptxas serialised them, and the
// consumers fit in 168). Bound: one bf16 pass of the MLP at 989 TFLOP/s plus
// the same float32 operations, 0.360 ms at 5120 x 778 vertices.

#include "hand_energy_core.cuh"
#include "sdf_mlp_wgmma.cuh"

namespace {

using namespace hotrack;

constexpr int kJoints = 16;
constexpr int kRoles = 12;     // 9 rotation entries, 3 translation entries

// Floats (bytes for the mask) from one sequence's per-call input to the
// next; 0 shares the input between the sequences.
struct SeqStrides {
  long long posedirs, v_shaped, weights, frame, mask, packed;
};

// ---- 3xTF32: the skinning pre-pass and the walk's rows ----

constexpr int kPassVerts = 32;      // vertices a block of the pre-pass: one a lane
constexpr int kPassCands = 32;      // candidates a block: four a warp
constexpr int kPassThreads = 256;
static_assert(kPassCands == 4 * (kPassThreads / 32), "a warp builds four candidates");

// Floats of the pre-pass's shared memory at K = k: the block's candidates'
// pose_map [k], rt [12 x 16] and offset [4] (entry e of candidate c at
// 32 e + c), then its vertices' columns of posedirs [3 k], v_shaped [3] and
// weights [16] (entry e of vertex j at 32 e + j).
__host__ __device__ inline long long pass_floats(int k) {
  return static_cast<long long>(kPassCands) * (k + kRoles * kJoints + 4) +
         static_cast<long long>(kPassVerts) * (3 * k + 3 + kJoints);
}

// Block (x, y, z) builds vertices 32 x .. 32 x + 31 of candidates 32 y ..
// 32 y + 31 of sequence z into verts (S, P, N, 3) and stores their hits.
__global__ void __launch_bounds__(kPassThreads, 2)
skin_vertices_kernel(const float* __restrict__ pose_map_g, const float* __restrict__ rt_g,
                     const float* __restrict__ offset_g, const float* __restrict__ posedirs_g,
                     const float* __restrict__ v_shaped_g, const float* __restrict__ weights_g,
                     const float* __restrict__ frame_g, const unsigned char* __restrict__ mask_g,
                     float* __restrict__ verts_g, float* __restrict__ hit_g, int p, int k, int n,
                     int h, int w, SeqStrides seq) {
  extern __shared__ float4 pass4[];
  float* pm = reinterpret_cast<float*>(pass4);             // [k][32]
  float* rt = pm + kPassCands * k;                          // [12 x 16][32]
  float* og = rt + kPassCands * kRoles * kJoints;           // [4][32]
  float* pd = og + kPassCands * 4;                          // [3 k][32]
  float* vs = pd + kPassVerts * 3 * k;                      // [3][32]
  float* wt = vs + kPassVerts * 3;                          // [16][32]
  const long long s = blockIdx.z;
  const int v0 = blockIdx.x * kPassVerts, p0 = blockIdx.y * kPassCands;
  const int tid = threadIdx.x, lane = tid & 31, cq = 4 * (tid >> 5);
  const long long cands = s * p + p0;   // the block's first candidate
  // the candidates' inputs (zeros past p) and the vertices' columns (zeros past n)
  for (int i = tid; i < kPassCands * k; i += kPassThreads)
    pm[i] = p0 + (i & 31) < p ? __ldg(pose_map_g + (cands + (i & 31)) * k + (i >> 5)) : 0.0f;
  for (int i = tid; i < kPassCands * kRoles * kJoints; i += kPassThreads)
    rt[i] = p0 + (i & 31) < p
                ? __ldg(rt_g + (cands + (i & 31)) * (kRoles * kJoints) + (i >> 5)) : 0.0f;
  if (tid < kPassCands * 4)
    og[tid] = p0 + (tid & 31) < p && tid < kPassCands * 3
                  ? __ldg(offset_g + (cands + (tid & 31)) * 3 + (tid >> 5)) : 0.0f;
  const bool real_v = v0 + lane < n;
  const float* posedirs = posedirs_g + s * seq.posedirs + v0;
  const float* v_shaped = v_shaped_g + s * seq.v_shaped + v0;
  const float* weights = weights_g + s * seq.weights + v0;
  for (int i = tid; i < kPassVerts * 3 * k; i += kPassThreads)
    pd[i] = v0 + (i & 31) < n ? __ldg(posedirs + static_cast<long long>(i >> 5) * n + (i & 31))
                              : 0.0f;
  if (tid < kPassVerts * 3)
    vs[tid] = real_v ? __ldg(v_shaped + static_cast<long long>(tid >> 5) * n + lane) : 0.0f;
  for (int i = tid; i < kPassVerts * kJoints; i += kPassThreads)
    wt[i] = v0 + (i & 31) < n ? __ldg(weights + static_cast<long long>(i >> 5) * n + (i & 31))
                              : 0.0f;
  __syncthreads();
  // vp_c of the four candidates: a fmaf chain in ascending k from 0, then + v_shaped
  float vp[3][4];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float a[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    const float* col = pd + c * k * kPassVerts + lane;
#pragma unroll 5
    for (int kk = 0; kk < k; ++kk) {
      const float d = col[kk * kPassVerts];
      const float4 q = *reinterpret_cast<const float4*>(pm + kk * kPassCands + cq);
      a[0] = fmaf(d, q.x, a[0]);
      a[1] = fmaf(d, q.y, a[1]);
      a[2] = fmaf(d, q.z, a[2]);
      a[3] = fmaf(d, q.w, a[3]);
    }
    const float vsc = vs[c * kPassVerts + lane];
#pragma unroll
    for (int i = 0; i < 4; ++i) vp[c][i] = __fadd_rn(a[i], vsc);
  }
  float wv[kJoints];
#pragma unroll
  for (int j = 0; j < kJoints; ++j) wv[j] = wt[j * kPassVerts + lane];
  // x_c = ((s_3c vp_0 + s_3c+1 vp_1 + s_3c+2 vp_2) + s_9+c) + offset_c, each
  // s_r a fmaf chain over the 16 joints in ascending order from 0
  float x[3][4];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float a[4], b[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float* r = rt + (e < 3 ? 3 * c + e : 9 + c) * kJoints * kPassCands + cq;
#pragma unroll
      for (int i = 0; i < 4; ++i) b[i] = 0.0f;
#pragma unroll
      for (int j = 0; j < kJoints; ++j) {
        const float4 q = *reinterpret_cast<const float4*>(r + j * kPassCands);
        b[0] = fmaf(q.x, wv[j], b[0]);
        b[1] = fmaf(q.y, wv[j], b[1]);
        b[2] = fmaf(q.z, wv[j], b[2]);
        b[3] = fmaf(q.w, wv[j], b[3]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (e == 0) a[i] = __fmul_rn(b[i], vp[0][i]);
        else if (e < 3) a[i] = fmaf(b[i], vp[e][i], a[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      x[c][i] = __fadd_rn(__fadd_rn(a[i], b[i]), og[c * kPassCands + cq + i]);
  }
  if (!real_v) return;
  const float* frame = frame_g + s * seq.frame;
  const unsigned char* mask = mask_g + s * seq.mask;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (p0 + cq + i < p) {
      const long long at = (cands + cq + i) * n + v0 + lane;
      verts_g[3 * at] = x[0][i];
      verts_g[3 * at + 1] = x[1][i];
      verts_g[3 * at + 2] = x[2][i];
      hit_g[at] = silhouette_hit(mask, h, w, frame, x[0][i], x[1][i], x[2][i]);
    }
  }
}

// The walk's rows in 3xTF32: row r of sequence s is the pre-pass's vertex r
// (candidate r / n, vertex r % n), in the camera frame.
struct Rows : wg::Job {
  const float* __restrict__ verts;   // (n_seq, m, 3)
  const float* __restrict__ frame;   // (16,), frame_seq floats a sequence
  float* __restrict__ sdf;           // (n_seq, m)
  long long m, frame_seq;            // m = p n

  __device__ __forceinline__ void load(long long s, long long row, float (&x)[3]) const {
    x[0] = x[1] = x[2] = 0.0f;
    if (row >= m) return;
    const float* q = verts + 3 * (s * m + row);
    x[0] = __ldg(q);
    x[1] = __ldg(q + 1);
    x[2] = __ldg(q + 2);
  }
  __device__ __forceinline__ void place(long long s, long long, const float (&raw)[3],
                                        float scale, float (&x)[3]) const {
    float f[12];
#pragma unroll
    for (int i = 0; i < 12; ++i) f[i] = wg::frame_at(frame + s * frame_seq + i);
    scaled_object_frame(f, scale, raw[0], raw[1], raw[2], x);
  }
  __device__ __forceinline__ void store(long long s, long long row, float value) const {
    sdf[s * m + row] = value;
  }
};

__global__ void __launch_bounds__(wg::kThreads, 1)
hand_energy_rows_kernel(const __grid_constant__ Rows job, const float* __restrict__ packed,
                        long long packed_seq, long long rounds, long long items,
                        wg::Shape shape, int pinned, int ring) {
  extern __shared__ __align__(128) unsigned char smem[];
  wg::walk<false>(job, smem, packed, packed_seq, rounds, items, shape, pinned, ring);
}

// ---- bf16: the walk's job ----

constexpr int kQuad = 4;    // candidates a round: rows 4 j + c
constexpr int kTile = 32;   // vertices a round: one an aside lane
constexpr int kBatch = 8;   // shared-memory loads issued together in the sums

// Floats of the staged inputs of a quad: pose_map (k, padded to 4), rt
// (12 x 16), offset (3, padded to 4), each entry e of candidate c at 4 e + c.
__host__ __device__ inline int quad_entries(int k) {
  return wg::round_up4(k) + kRoles * kJoints + 4;
}

// 4 bytes from device memory into shared memory without holding a register
// (cp.async; zeros when bytes is 0); copies_done waits for the thread's own.
__device__ __forceinline__ void copy4(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(wg::smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void copies_done() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

struct Skinned : wg::Job {
  static constexpr int kStage = 2;
  // the aside's sums want room to issue their shared-memory loads ahead of the
  // FMAs, and the consumers' bf16 MLP and `take` fit beside them: every warp
  // keeps the launch's 168
  static constexpr int kConsumerRegs = wg::kLaunchRegs;
  static constexpr int kProducerRegs = wg::kLaunchRegs;
  const float* __restrict__ pose_map;   // (n_seq, p, k)
  const float* __restrict__ rt;         // (n_seq, p, 12, 16)
  const float* __restrict__ offset;     // (n_seq, p, 3)
  const float* __restrict__ posedirs;   // (3, k, n), seq.posedirs apart
  const float* __restrict__ v_shaped;   // (3, n)
  const float* __restrict__ weights;    // (16, n)
  const float* __restrict__ frame;      // (16,)
  const unsigned char* __restrict__ mask;
  float* __restrict__ sdf;              // (n_seq, p, n)
  float* __restrict__ hit;
  SeqStrides seq;
  long long m;                          // rows a sequence: tiles x quads x 128
  int p, k, n, h, w, tiles, quads;      // tiles = ceil(n / 32), quads = ceil(p / 4)

  // scratch (floats): the staged tile's key (an int the walk sets to -1, then
  // 3 floats of padding), kStage slots of a round's vertices [c][128], the
  // swapped vp [c][128], the quad's inputs [quad_entries][4], each aside
  // thread's column of posedirs and v_shaped [k + 1][96], the tile's weights
  // [16][32]
  __host__ long long scratch_bytes() const {
    return 4LL * (4 + (kStage + 1) * 3 * wg::kRoundPoints + kQuad * quad_entries(k) +
                  (k + 1) * wg::kAsideThreads + kJoints * kTile);
  }
  __device__ __forceinline__ float* slot_at(unsigned char* scratch, int slot) const {
    return reinterpret_cast<float*>(scratch) + 4 + slot * 3 * wg::kRoundPoints;
  }

  // Row r of a sequence (r < m < 2^31): round r / 128 is vertex tile
  // round / quads and quad round % quads (tile-major, so that a block's
  // rounds b, b + grid, ... stay on one tile for about quads / grid rounds);
  // row 4 j + c of the round is candidate 4 quad + c's vertex 32 tile + j.
  // False past n or p.
  __device__ __forceinline__ bool row_at(unsigned r, int& cand, int& v) const {
    const unsigned round = r / wg::kRoundPoints, i = r % wg::kRoundPoints;
    const unsigned tile = round / static_cast<unsigned>(quads);
    v = static_cast<int>(kTile * tile + i / kQuad);
    cand = static_cast<int>(kQuad * (round - tile * quads) + i % kQuad);
    return v < n && cand < p;
  }

  // The aside warps: round `round` of sequence s into stage slot `slot`.
  // Warp 9 + c, lane j takes coordinate c of vertex 32 tile + j for the quad's
  // four candidates (rows 4 j .. 4 j + 3): a posedirs value is loaded once for
  // four candidates, and once for every round of its tile that the block
  // walks (the columns stay staged while the tile does).
  __device__ __forceinline__ void build(long long s, long long round, int t, int slot,
                                        unsigned char* scratch) const {
    float* xs = slot_at(scratch, slot);
    float* vps = slot_at(scratch, kStage);
    float* in = vps + 3 * wg::kRoundPoints;
    const float4* in4 = reinterpret_cast<const float4*>(in);
    float* cols = in + kQuad * quad_entries(k);   // [k + 1][96]
    float* wcols = cols + (k + 1) * wg::kAsideThreads;   // [16][32]
    int* staged = reinterpret_cast<int*>(scratch);
    const int c = t >> 5, j = t & 31;
    const int tile = static_cast<int>(round / quads), q = static_cast<int>(round % quads);
    const int v = kTile * tile + j, first = kQuad * q, count = min(kQuad, p - first);
    const int k4 = wg::round_up4(k);
    const long long cands = s * p + first;   // the quad's first candidate
    // the tile's columns: posedirs and v_shaped of (c, v), weights of v
    const int key = static_cast<int>(s) * tiles + tile;
    const bool restage = *staged != key;
    if (restage && v < n) {
      const float* pd = posedirs + s * seq.posedirs + static_cast<long long>(c) * k * n + v;
      for (int kk = 0; kk < k; ++kk)
        copy4(cols + kk * wg::kAsideThreads + t, pd + static_cast<long long>(kk) * n, 4);
      copy4(cols + k * wg::kAsideThreads + t,
            v_shaped + s * seq.v_shaped + static_cast<long long>(c) * n + v, 4);
      for (int jj = c; jj < kJoints; jj += 3)
        copy4(wcols + jj * kTile + j,
              weights + s * seq.weights + static_cast<long long>(jj) * n + v, 4);
    }
    // the quad's inputs, zeros for candidates past p (the last candidate's
    // address, no bytes read): entry e of candidate cq at 4 e + cq, one source
    // array at a time
    for (int i = t; i < kQuad * k; i += wg::kAsideThreads) {
      const int cq = i & 3;
      copy4(in + i, pose_map + (cands + min(cq, count - 1)) * k + (i >> 2),
            cq < count ? 4 : 0);
    }
    for (int i = t; i < kQuad * kRoles * kJoints; i += wg::kAsideThreads) {
      const int cq = i & 3;
      copy4(in + kQuad * k4 + i,
            rt + (cands + min(cq, count - 1)) * (kRoles * kJoints) + (i >> 2),
            cq < count ? 4 : 0);
    }
    if (t < kQuad * 3) {
      const int cq = t & 3;
      copy4(in + kQuad * (k4 + kRoles * kJoints) + t,
            offset + (cands + min(cq, count - 1)) * 3 + (t >> 2), cq < count ? 4 : 0);
    }
    copies_done();
    wg::aside_sync();   // the staged inputs are in; every thread has read `staged`
    if (restage && t == 0) *staged = key;
    // coordinate c of the four candidates' vertex v: a fmaf chain in ascending
    // k from 0, then + v_shaped (kBatch loads issued together)
    float a[kQuad] = {0.0f, 0.0f, 0.0f, 0.0f};
    const float* col = cols + t;
    int kk = 0;
    for (; kk + kBatch <= k; kk += kBatch) {
      float d[kBatch];
      float4 pm[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        d[u] = col[(kk + u) * wg::kAsideThreads];
        pm[u] = in4[kk + u];
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        a[0] = fmaf(d[u], pm[u].x, a[0]);
        a[1] = fmaf(d[u], pm[u].y, a[1]);
        a[2] = fmaf(d[u], pm[u].z, a[2]);
        a[3] = fmaf(d[u], pm[u].w, a[3]);
      }
    }
    for (; kk < k; ++kk) {
      const float d = col[kk * wg::kAsideThreads];
      const float4 pm = in4[kk];
      a[0] = fmaf(d, pm.x, a[0]);
      a[1] = fmaf(d, pm.y, a[1]);
      a[2] = fmaf(d, pm.z, a[2]);
      a[3] = fmaf(d, pm.w, a[3]);
    }
    const float vs = col[k * wg::kAsideThreads];
#pragma unroll
    for (int i = 0; i < kQuad; ++i) vps[c * wg::kRoundPoints + kQuad * j + i] = __fadd_rn(a[i], vs);
    wg::aside_sync();   // vp of every coordinate
    // x_c = ((s_3c vp_0 + s_3c+1 vp_1 + s_3c+2 vp_2) + s_9+c) + offset_c, each
    // s_r a fmaf chain over the 16 joints in ascending order from 0
    const float* vq = vps + kQuad * j;
    float b[kQuad];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int at = k4 + (e < 3 ? 3 * c + e : 9 + c) * kJoints;
#pragma unroll
      for (int i = 0; i < kQuad; ++i) b[i] = 0.0f;
#pragma unroll
      for (int j0 = 0; j0 < kJoints; j0 += kBatch) {
        float wv[kBatch];
        float4 r[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          wv[u] = wcols[(j0 + u) * kTile + j];
          r[u] = in4[at + j0 + u];
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          b[0] = fmaf(r[u].x, wv[u], b[0]);
          b[1] = fmaf(r[u].y, wv[u], b[1]);
          b[2] = fmaf(r[u].z, wv[u], b[2]);
          b[3] = fmaf(r[u].w, wv[u], b[3]);
        }
      }
#pragma unroll
      for (int i = 0; i < kQuad; ++i) {
        if (e == 0) a[i] = __fmul_rn(b[i], vq[i]);
        else if (e < 3) a[i] = fmaf(b[i], vq[e * wg::kRoundPoints + i], a[i]);
      }
    }
    const float4 og = in4[k4 + kRoles * kJoints + c];
    const float ogs[kQuad] = {og.x, og.y, og.z, og.w};
#pragma unroll
    for (int i = 0; i < kQuad; ++i)   // rows past n or p: finite inputs, stored nowhere
      xs[c * wg::kRoundPoints + kQuad * j + i] =
          v < n && i < count ? __fadd_rn(__fadd_rn(a[i], b[i]), ogs[i]) : 0.0f;
    wg::aside_sync();   // the round's vertices are in the slot
    // the hits: warp 9 + c takes rows 4 j + c (and warp 9 rows 4 j + 3)
    const float* frame_s = frame + s * seq.frame;
    const unsigned char* mask_s = mask + s * seq.mask;
    for (int i = c; i < kQuad; i += 3) {
      const int row = kQuad * j + i;
      if (v < n && i < count)
        hit[(cands + i) * n + v] = silhouette_hit(mask_s, h, w, frame_s, xs[row],
                                                  xs[wg::kRoundPoints + row],
                                                  xs[2 * wg::kRoundPoints + row]);
    }
  }

  // A consumer: row's vertex from the slot, into the object's frame, scaled.
  __device__ __forceinline__ void take(long long s, long long row, int slot,
                                       const unsigned char* scratch, float scale,
                                       float (&x)[3]) const {
    const float* xs = slot_at(const_cast<unsigned char*>(scratch), slot);
    const int i = static_cast<int>(row & (wg::kRoundPoints - 1));
    float f[12];
#pragma unroll
    for (int e = 0; e < 12; ++e) f[e] = wg::frame_at(frame + s * seq.frame + e);
    scaled_object_frame(f, scale, xs[i], xs[wg::kRoundPoints + i], xs[2 * wg::kRoundPoints + i],
                        x);
  }

  __device__ __forceinline__ void store(long long s, long long row, float value) const {
    int cand, v;
    if (row_at(static_cast<unsigned>(row), cand, v)) sdf[(s * p + cand) * n + v] = value;
  }
};

__global__ void __launch_bounds__(wg::kThreads, 1)
hand_energy_skin_wg_kernel(const __grid_constant__ Skinned job, const float* __restrict__ packed,
                           long long rounds, long long items, wg::Shape shape, int pinned,
                           int ring) {
  extern __shared__ __align__(128) unsigned char smem[];
  wg::walk<true>(job, smem, packed, job.seq.packed, rounds, items, shape, pinned, ring);
}

int g_smem_limit = 0;     // what a block of any of the three kernels may opt into
wg::Grid g_grid_rows;     // the 3xTF32 walk's
wg::Grid g_grid_wg;       // the bf16 walk's

int launch(const void* pose_map, const void* rt, const void* offset, const void* posedirs,
           const void* v_shaped, const void* weights, const void* frame, const void* mask,
           const void* packed, void* sdf, void* hit, void* verts, int p, int k, int n, int h,
           int w, int n_seq, const SeqStrides& seq, int n_freqs, int n_hidden,
           const int* widths, void* stream) {
  const wg::Shape shape = wg::make_shape(n_freqs, n_hidden, widths);
  const long long pass_smem = 4 * pass_floats(k);
  const int tiles = (n + kPassVerts - 1) / kPassVerts, chunks = (p + kPassCands - 1) / kPassCands;
  if (shape.tiles == 0 || pass_smem > g_smem_limit || chunks > 65535 || n_seq > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  skin_vertices_kernel<<<dim3(tiles, chunks, n_seq), kPassThreads,
                         static_cast<size_t>(pass_smem), st>>>(
      static_cast<const float*>(pose_map), static_cast<const float*>(rt),
      static_cast<const float*>(offset), static_cast<const float*>(posedirs),
      static_cast<const float*>(v_shaped), static_cast<const float*>(weights),
      static_cast<const float*>(frame), static_cast<const unsigned char*>(mask),
      static_cast<float*>(verts), static_cast<float*>(hit), p, k, n, h, w, seq);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long m = static_cast<long long>(p) * n;
  const long long rounds = (m + wg::kRoundPoints - 1) / wg::kRoundPoints;
  int pinned = 0, ring = 0;
  long long smem = 0;
  unsigned grid = 0;
  err = wg::plan_launch(hand_energy_rows_kernel, shape, g_smem_limit, rounds * n_seq,
                        g_grid_rows, pinned, ring, smem, grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Rows job{{}, static_cast<const float*>(verts), static_cast<const float*>(frame),
                 static_cast<float*>(sdf), m, seq.frame};
  hand_energy_rows_kernel<<<grid, wg::kThreads, static_cast<size_t>(smem), st>>>(
      job, static_cast<const float*>(packed), seq.packed, rounds, rounds * n_seq, shape, pinned,
      ring);
  return static_cast<int>(cudaGetLastError());
}

int launch_bf16(const void* pose_map, const void* rt, const void* offset, const void* posedirs,
                const void* v_shaped, const void* weights, const void* frame, const void* mask,
                const void* packed, void* sdf, void* hit, int p, int k, int n, int h, int w,
                int n_seq, const SeqStrides& seq, int n_freqs, int n_hidden, const int* widths,
                void* stream) {
  const wg::Shape shape = wg::make_shape(n_freqs, n_hidden, widths, true);
  const int tiles = (n + kTile - 1) / kTile, quads = (p + kQuad - 1) / kQuad;
  const long long rounds = static_cast<long long>(tiles) * quads;
  if (shape.tiles == 0 || rounds * wg::kRoundPoints > 2147483647LL ||
      static_cast<long long>(tiles) * n_seq > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  const Skinned job{{}, static_cast<const float*>(pose_map), static_cast<const float*>(rt),
                    static_cast<const float*>(offset), static_cast<const float*>(posedirs),
                    static_cast<const float*>(v_shaped), static_cast<const float*>(weights),
                    static_cast<const float*>(frame), static_cast<const unsigned char*>(mask),
                    static_cast<float*>(sdf), static_cast<float*>(hit), seq,
                    rounds * wg::kRoundPoints, p, k, n, h, w, tiles, quads};
  int pinned = 0, ring = 0;
  long long smem = 0;
  unsigned grid = 0;
  const cudaError_t err = wg::plan_launch(hand_energy_skin_wg_kernel, shape, g_smem_limit,
                                          rounds * n_seq, g_grid_wg, pinned, ring, smem, grid,
                                          wg::job_bytes(job));
  if (err != cudaSuccess) return static_cast<int>(err);
  hand_energy_skin_wg_kernel<<<grid, wg::kThreads, static_cast<size_t>(smem),
                               static_cast<cudaStream_t>(stream)>>>(
      job, static_cast<const float*>(packed), rounds, rounds * n_seq, shape, pinned, ring);
  return static_cast<int>(cudaGetLastError());
}

// The arguments both entries take, checked; seq_strides: 6 host long longs.
bool bad_args(int p, int k, int n, int h, int w, int n_seq) {
  return p < 1 || k < 1 || n < 1 || h < 1 || w < 1 || n_seq < 1;
}
SeqStrides strides_of(const long long* seq_strides) {
  return {seq_strides[0], seq_strides[1], seq_strides[2], seq_strides[3], seq_strides[4],
          seq_strides[5]};
}

}  // namespace

extern "C" {

// Opts the three kernels into as much dynamic shared memory as a block may
// have on the current device, once per process; a launch takes what its net
// and K need.
int hotrack_hand_energy_skin_init() {
  cudaError_t err = wg::opt_in(hand_energy_rows_kernel, g_smem_limit);
  if (err == cudaSuccess) err = wg::opt_in(hand_energy_skin_wg_kernel, g_smem_limit);
  if (err == cudaSuccess) err = wg::opt_in(skin_vertices_kernel, g_smem_limit);
  return static_cast<int>(err);
}

// pose_map (p, k), rt (p, 12, 16), offset (p, 3), posedirs (3, k, n), v_shaped (3, n),
// weights (16, n), frame (16,), mask (h, ceil(w / 8)) uint8, packed (PackedSDF.wg),
// sdf (p, n), hit (p, n), verts (p, n, 3) scratch, each with a leading n_seq: device
// pointers; seq_strides: 6 host long longs, SeqStrides' fields in order; widths:
// n_hidden + 1 host ints. Returns cudaErrorInvalidValue when the pre-pass's
// shared memory does not fit a block (k above about 400).
int hotrack_hand_energy_skin(const void* pose_map, const void* rt, const void* offset,
                             const void* posedirs, const void* v_shaped, const void* weights,
                             const void* frame, const void* mask, const void* packed,
                             void* sdf, void* hit, void* verts, int p, int k, int n, int h,
                             int w, int n_seq, const long long* seq_strides, int n_freqs,
                             int n_hidden, const int* widths, void* stream) {
  if (bad_args(p, k, n, h, w, n_seq)) return static_cast<int>(cudaErrorInvalidValue);
  return launch(pose_map, rt, offset, posedirs, v_shaped, weights, frame, mask, packed, sdf, hit,
                verts, p, k, n, h, w, n_seq, strides_of(seq_strides), n_freqs, n_hidden, widths,
                stream);
}

// The same in bf16 on the fused walk job, without the scratch: packed is
// PackedSDF.wg16.
int hotrack_hand_energy_skin_bf16(const void* pose_map, const void* rt, const void* offset,
                                  const void* posedirs, const void* v_shaped,
                                  const void* weights, const void* frame, const void* mask,
                                  const void* packed, void* sdf, void* hit, int p, int k, int n,
                                  int h, int w, int n_seq, const long long* seq_strides,
                                  int n_freqs, int n_hidden, const int* widths, void* stream) {
  if (bad_args(p, k, n, h, w, n_seq)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_bf16(pose_map, rt, offset, posedirs, v_shaped, weights, frame, mask, packed, sdf,
                     hit, p, k, n, h, w, n_seq, strides_of(seq_strides), n_freqs, n_hidden,
                     widths, stream);
}

}  // extern "C"
