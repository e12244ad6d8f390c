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
// fused_hand_energy, with the vertices never written to device memory.
// Inputs: per candidate pose_map (P, K), rt (P, 12, 16) (rt_flat of
// mano/layer.py mano_skin_inputs), offset (P, 3); per call, vertex-minor,
// posedirs (3, K, N), v_shaped (3, N), weights (16, N). Not carried over from
// the TPU: vertices padded to a lane multiple, the particle tile with its
// role-major slab and sub-tiles, P padded by repeating particle 0.
//
// Bound: operations. A vertex costs the MLP's 71,168 operations, three
// tensor-core passes of them in 3xTF32 at 495 TFLOP/s, plus 1,239 float32
// operations at 67 TFLOP/s: 2 (3 K + 12 * 16) + 18 = 1,212 of skinning at
// K = 135 and 27 of transform and projection. At 5120 x 778 vertices that is
// 1.792 ms (4.305 ms with the MLP in float32 FMA); the inputs are 1.35 KB a
// candidate and 1.3 MB a call, the outputs 8 bytes a vertex.
// Precision: the skinning is float32 FMA with float32 accumulation, sums in
// ascending k and j from 0, the transform and projection as in
// hand_energy_core.cuh, so the vertices and the hit are what they were with
// the float32 MLP; the MLP's hidden layers are 3xTF32 (sdf_mlp_tc.cuh).
//
// Design: a persistent grid of one block (256 threads, 8 warps) an SM, each
// walking the (sequence, pair of candidates) items b, b + grid, ... in
// ascending order, with the model's weights resident in shared memory
// (copied again only when the walk enters another sequence). Phase 1 builds
// an item's vertices into shared memory (2 x 3 x N floats): a thread takes a
// vertex and computes it for both candidates, so a value of posedirs or
// weights is loaded once (through L1/L2, neighbouring threads on neighbouring
// addresses) and used twice, and the block's two halves take alternate tiles
// of 128 vertices. Phase 2 walks the pair's 2 N vertices as one flat list in
// rounds of 128, 16 a warp as the mma tiles' rows, so only the list's last
// round is ragged (13 rounds for 2 x 778 vertices): the object-frame
// transform, the MLP on the tensor cores and the pixel lookup (a lane a
// vertex). With an odd P the last pair has one candidate. Shared memory:
// 197,632 bytes of weights for 21-128-128-128-1, 18,688 of vertices and 2,656
// of per-candidate inputs at N = 778, K = 135. No atomics; nothing depends on
// the grid or on the block that took the item, so two launches agree
// bitwise. Sequences: the per-candidate inputs and the outputs are
// (S, P, ...); each per-call input (posedirs, v_shaped, weights, frame, mask,
// packed model) lies s times its own stride further on, and a stride of 0
// shares it between the sequences (posedirs and weights always are). An
// unbatched launch is the case of one sequence: sequence s of a batched launch
// computes bitwise what an unbatched launch on s's inputs computes.
//
// bf16 (HOTRACK_SDF_BF16), entry hotrack_hand_energy_skin_bf16: a job on the
// persistent bf16 wgmma walk of sdf_mlp_wgmma.cuh (wg::walk<true>, wgmma
// m64n128k16, PackedSDF.wg16), the walk that #3 and #6 run, with the skinning
// off the consumers' path. Rows: a round of 128 is a tile of 32 vertices by a
// quad of 4 candidates, rounds tile-major, and row 4 j + c of a round is
// candidate 4 quad + c's vertex 32 tile + j (rows past N or P are padding: 2.8%
// at N = 778, none past P at P = 5120). The producer warpgroup's three aside
// warps build each round's camera-frame vertices into a stage of shared memory
// (kStage slots, up to two rounds ahead of the consumers, a full and an empty
// mbarrier a slot, the walk's staged-input handshake): warp 9 + c, lane j
// computes coordinate c of vertex 32 tile + j for the quad's four candidates
// from the quad's per-candidate inputs (pose_map, rt, offset), staged in shared
// memory for the round, and the tile's columns of posedirs, v_shaped and
// weights, staged when a block's round moves to another tile or sequence (a
// block's rounds b, b + 132, ... stay on one tile for about quads / 132 of
// them: a posedirs value is loaded once for four candidates and for about ten
// rounds); the three warps swap vp through shared memory, each finishes
// coordinate c of x, then they look up the round's hits. The staged inputs
// arrive by cp.async. The arithmetic is phase 1's above (sums in ascending k
// and j from 0, FMA), so the vertices and the hits are bitwise the 3xTF32
// kernel's. The consumers take a row's vertex from the stage and move it into
// the object's frame, scaled, as hand_energy.cu's `place` does, and store the
// sdf. Registers: the launch's 168 for every warp (no setmaxnreg: the aside's
// sums need room to issue their shared-memory loads ahead of the FMAs; at 72
// ptxas serialised them, and the consumers fit in 168).
// Bound: one bf16 pass of the MLP at 989 TFLOP/s plus the same float32
// operations, 0.360 ms at 5120 x 778 vertices.

#include "hand_energy_core.cuh"
#include "sdf_mlp_wgmma.cuh"

namespace {

using namespace hotrack;

constexpr int kPair = 2;       // candidates a block item
constexpr int kJoints = 16;
constexpr int kRoles = 12;     // 9 rotation entries, 3 translation entries
constexpr int kTilePoints = 128;
static_assert(tc::kThreads == 2 * kTilePoints, "phase 1 takes two tiles of vertices a pass");

// Floats (bytes for the mask) from one sequence's per-call input to the
// next; 0 shares the input between the sequences.
struct SeqStrides {
  long long posedirs, v_shaped, weights, frame, mask, packed;
};

// floats of shared memory beyond the weights: the pair's vertices, then per
// candidate pose_map (K), rt (12 x 16) and offset (3, padded to 4)
__host__ __device__ inline int stage_floats(int k) {
  return tc::round_up4(k) + kRoles * kJoints + 4;
}
__host__ __device__ inline long long pair_floats(int k, int n) {
  return kPair * 3LL * tc::round_up4(n) + kPair * stage_floats(k);
}

__global__ void __launch_bounds__(tc::kThreads, 1)
hand_energy_skin_kernel(const float* __restrict__ pose_map_g, const float* __restrict__ rt_g,
                        const float* __restrict__ offset_g, const float* __restrict__ posedirs_g,
                        const float* __restrict__ v_shaped_g, const float* __restrict__ weights_g,
                        const float* __restrict__ frame_g,
                        const unsigned char* __restrict__ mask_g,
                        const float* __restrict__ packed_g, float* __restrict__ sdf_g,
                        float* __restrict__ hit_g, int p_total, int k_pose, int n, int h, int w,
                        long long items, SeqStrides seq, tc::Shape shape, int resident) {
  extern __shared__ float4 smem4[];
  float* wsm = reinterpret_cast<float*>(smem4);
  float* xs = wsm + tc::weight_smem_floats(shape, resident != 0);   // [cand][coord][n4]
  const int n4 = tc::round_up4(n);
  float* stage = xs + kPair * 3 * n4;                                 // [cand][stage_floats]
  const int stage_n = stage_floats(k_pose);
  const int k4 = tc::round_up4(k_pose);
  const int pairs = (p_total + kPair - 1) / kPair;

  const int tid = threadIdx.x;
  const int slot = tid & (kTilePoints - 1), half = tid >> 7;
  const int lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  long long loaded = -1;
  for (long long item = blockIdx.x; item < items; item += gridDim.x) {
    const long long s = item / pairs;
    const int p0 = static_cast<int>(item - s * pairs) * kPair;
    const int n_cand = min(kPair, p_total - p0);
    const float* pose_map = pose_map_g + s * p_total * k_pose;
    const float* rt = rt_g + s * p_total * (kRoles * kJoints);
    const float* offset = offset_g + s * p_total * 3;
    const float* posedirs = posedirs_g + s * seq.posedirs;
    const float* v_shaped = v_shaped_g + s * seq.v_shaped;
    const float* weights = weights_g + s * seq.weights;
    const unsigned char* mask = mask_g + s * seq.mask;
    const tc::Net net = tc::net_of(packed_g + s * seq.packed, shape);
    if (resident && s != loaded) {
      tc::load_resident(wsm, net, shape);
      loaded = s;
    }
    __syncthreads();   // the previous item's phase 2 has read xs

    // the pair's per-candidate inputs into shared memory (zeros for a missing one)
    for (int i = tid; i < kPair * stage_n; i += tc::kThreads) {
      const int c = i / stage_n, j = i - c * stage_n;
      const long long p = p0 + c;
      float v = 0.0f;
      if (c < n_cand) {
        if (j < k_pose) v = __ldg(pose_map + p * k_pose + j);
        else if (j >= k4 && j < k4 + kRoles * kJoints)
          v = __ldg(rt + p * (kRoles * kJoints) + (j - k4));
        else if (j >= k4 + kRoles * kJoints && j < k4 + kRoles * kJoints + 3)
          v = __ldg(offset + p * 3 + (j - k4 - kRoles * kJoints));
      }
      stage[i] = v;
    }
    __syncthreads();

    // ---- phase 1: the pair's vertices, float32 FMA ----
    const float* pm0 = stage;
    const float* pm1 = stage + stage_n;
    for (int base = half * kTilePoints; base < n; base += 2 * kTilePoints) {
      const int v = base + slot;
      if (v >= n) continue;
      float vp[kPair][3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float* pd = posedirs + static_cast<long long>(c) * k_pose * n + v;
        float a0 = 0.0f, a1 = 0.0f;
#pragma unroll 9
        for (int k = 0; k < k_pose; ++k) {
          const float d = __ldg(pd + static_cast<long long>(k) * n);
          a0 = fmaf(d, pm0[k], a0);
          a1 = fmaf(d, pm1[k], a1);
        }
        const float vs = __ldg(v_shaped + static_cast<long long>(c) * n + v);
        vp[0][c] = __fadd_rn(a0, vs);
        vp[1][c] = __fadd_rn(a1, vs);
      }
      float wv[kJoints];
#pragma unroll
      for (int j = 0; j < kJoints; ++j) wv[j] = __ldg(weights + static_cast<long long>(j) * n + v);
#pragma unroll
      for (int c2 = 0; c2 < kPair; ++c2) {
        const float* rg = stage + c2 * stage_n + k4;       // [role][joint]
        const float* og = rg + kRoles * kJoints;
        float sr[kRoles];
#pragma unroll
        for (int r = 0; r < kRoles; ++r) {
          float a = 0.0f;
#pragma unroll
          for (int j = 0; j < kJoints; ++j) a = fmaf(rg[r * kJoints + j], wv[j], a);
          sr[r] = a;
        }
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          float a = __fmul_rn(sr[3 * c], vp[c2][0]);
          a = fmaf(sr[3 * c + 1], vp[c2][1], a);
          a = fmaf(sr[3 * c + 2], vp[c2][2], a);
          xs[(c2 * 3 + c) * n4 + v] = __fadd_rn(__fadd_rn(a, sr[9 + c]), og[c]);
        }
      }
    }
    __syncthreads();

    // ---- phase 2: the per-vertex energy over the pair's flat vertex list,
    // 16 vertices a warp a round, the MLP on the tensor cores ----
    float frame[kFrameFloats];
#pragma unroll
    for (int i = 0; i < kFrameFloats; ++i) frame[i] = __ldg(frame_g + s * seq.frame + i);
    const int total = n_cand * n;
    float* sdf_out = sdf_g + (s * p_total + p0) * static_cast<long long>(n);
    float* hit_out = hit_g + (s * p_total + p0) * static_cast<long long>(n);
    for (int base = 0; base < total; base += tc::kRoundPoints) {
      const int row0 = base + warp * tc::kRows;
      float xa[3] = {0.0f, 0.0f, 0.0f}, xb[3] = {0.0f, 0.0f, 0.0f};
      float cam[3];
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        // r 0, 1: the mma rows g and g + 8; r 2: the lane's own vertex for the hit
        const int i = row0 + (r == 2 ? lane : g + 8 * r);
        if (i >= total || (r == 2 && lane >= tc::kRows)) continue;
        const int c2 = i >= n ? 1 : 0;
        const int v = i - c2 * n;
        const float x = xs[(c2 * 3 + 0) * n4 + v], y = xs[(c2 * 3 + 1) * n4 + v],
                    z = xs[(c2 * 3 + 2) * n4 + v];
        if (r == 2) {
          cam[0] = x; cam[1] = y; cam[2] = z;
        } else {
          float obj[3];
          scaled_object_frame(frame, net.scale, x, y, z, obj);
          float (&dst)[3] = r == 0 ? xa : xb;
          dst[0] = obj[0]; dst[1] = obj[1]; dst[2] = obj[2];
        }
      }
      if (lane < tc::kRows && row0 + lane < total)
        hit_out[row0 + lane] = silhouette_hit(mask, h, w, frame, cam[0], cam[1], cam[2]);
      const float2 sdf = tc::mlp_rows(xa, xb, net, shape, resident != 0, wsm);
      if (t == 0) {
        if (row0 + g < total) sdf_out[row0 + g] = sdf.x;
        if (row0 + g + 8 < total) sdf_out[row0 + g + 8] = sdf.y;
      }
    }
  }
}

// ---- bf16: the walk's job ----

constexpr int kQuad = 4;    // candidates a round: rows 4 j + c
constexpr int kTile = 32;   // vertices a round: one an aside lane
constexpr int kBatch = 8;   // shared-memory loads issued together in the sums

// Floats of the staged inputs of a quad: pose_map (k, padded to 4), rt
// (12 x 16), offset (3, padded to 4), each entry e of candidate c at 4 e + c.
__host__ __device__ inline int quad_entries(int k) {
  return tc::round_up4(k) + kRoles * kJoints + 4;
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
    const int k4 = tc::round_up4(k);
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

int g_smem_limit = 0;            // what a block of either kernel may opt into
long long g_grid_smem = -1;      // persistent_blocks' memo
int g_grid_blocks = 0;
wg::Grid g_grid_wg;

int launch(const void* pose_map, const void* rt, const void* offset, const void* posedirs,
           const void* v_shaped, const void* weights, const void* frame, const void* mask,
           const void* packed, void* sdf, void* hit, int p, int k, int n, int h, int w, int n_seq,
           const SeqStrides& seq, int n_freqs, int n_hidden, const int* widths, void* stream) {
  const tc::Shape shape = tc::make_shape(n_freqs, n_hidden, widths);
  if (shape.k0 == 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long other = 4LL * pair_floats(k, n);
  const int resident = tc::resident_mode(shape, other, g_smem_limit);
  if (resident < 0 || static_cast<long long>(kPair) * n > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long smem = other + 4LL * tc::weight_smem_floats(shape, resident != 0);
  const long long items = static_cast<long long>((p + kPair - 1) / kPair) * n_seq;
  const int blocks = tc::persistent_blocks(hand_energy_skin_kernel, smem, g_grid_smem,
                                           g_grid_blocks);
  if (blocks < 1) {
    const cudaError_t err = cudaGetLastError();
    return static_cast<int>(err != cudaSuccess ? err : cudaErrorUnknown);
  }
  const unsigned grid = static_cast<unsigned>(items < blocks ? items : blocks);
  hand_energy_skin_kernel<<<grid, tc::kThreads, static_cast<size_t>(smem),
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pose_map), static_cast<const float*>(rt),
      static_cast<const float*>(offset), static_cast<const float*>(posedirs),
      static_cast<const float*>(v_shaped), static_cast<const float*>(weights),
      static_cast<const float*>(frame), static_cast<const unsigned char*>(mask),
      static_cast<const float*>(packed), static_cast<float*>(sdf), static_cast<float*>(hit), p,
      k, n, h, w, items, seq, shape, resident);
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
template <bool kBf16>
int launch_either(const void* pose_map, const void* rt, const void* offset, const void* posedirs,
                  const void* v_shaped, const void* weights, const void* frame, const void* mask,
                  const void* packed, void* sdf, void* hit, int p, int k, int n, int h, int w,
                  int n_seq, const long long* seq_strides, int n_freqs, int n_hidden,
                  const int* widths, void* stream) {
  if (p < 1 || k < 1 || n < 1 || h < 1 || w < 1 || n_seq < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const SeqStrides seq{seq_strides[0], seq_strides[1], seq_strides[2], seq_strides[3],
                       seq_strides[4], seq_strides[5]};
  return (kBf16 ? launch_bf16 : launch)(pose_map, rt, offset, posedirs, v_shaped, weights, frame,
                                        mask, packed, sdf, hit, p, k, n, h, w, n_seq, seq,
                                        n_freqs, n_hidden, widths, stream);
}

}  // namespace

extern "C" {

// Opts both instantiations into as much dynamic shared memory as a block may
// have on the current device, once per process; a launch takes what its net
// and N need.
int hotrack_hand_energy_skin_init() {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&g_smem_limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(hand_energy_skin_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, g_smem_limit);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(wg::opt_in(hand_energy_skin_wg_kernel, g_smem_limit));
}

// pose_map (p, k), rt (p, 12, 16), offset (p, 3), posedirs (3, k, n), v_shaped (3, n),
// weights (16, n), frame (16,), mask (h, ceil(w / 8)) uint8, packed (PackedSDF.tc),
// sdf (p, n), hit (p, n), each with a leading n_seq: device pointers; seq_strides:
// 6 host long longs, SeqStrides' fields in order; widths: n_hidden + 1 host ints.
// Returns cudaErrorInvalidValue when the pair's vertices and one layer of the
// net do not fit a block's shared memory (n above about 6000).
int hotrack_hand_energy_skin(const void* pose_map, const void* rt, const void* offset,
                             const void* posedirs, const void* v_shaped, const void* weights,
                             const void* frame, const void* mask, const void* packed,
                             void* sdf, void* hit, int p, int k, int n, int h, int w,
                             int n_seq, const long long* seq_strides, int n_freqs,
                             int n_hidden, const int* widths, void* stream) {
  return launch_either<false>(pose_map, rt, offset, posedirs, v_shaped, weights, frame, mask,
                              packed, sdf, hit, p, k, n, h, w, n_seq, seq_strides, n_freqs,
                              n_hidden, widths, stream);
}

// The same in bf16 on the wgmma walk: packed is PackedSDF.wg16.
int hotrack_hand_energy_skin_bf16(const void* pose_map, const void* rt, const void* offset,
                                  const void* posedirs, const void* v_shaped,
                                  const void* weights, const void* frame, const void* mask,
                                  const void* packed, void* sdf, void* hit, int p, int k, int n,
                                  int h, int w, int n_seq, const long long* seq_strides,
                                  int n_freqs, int n_hidden, const int* widths, void* stream) {
  return launch_either<true>(pose_map, rt, offset, posedirs, v_shaped, weights, frame, mask,
                             packed, sdf, hit, p, k, n, h, w, n_seq, seq_strides, n_freqs,
                             n_hidden, widths, stream);
}

}  // extern "C"
