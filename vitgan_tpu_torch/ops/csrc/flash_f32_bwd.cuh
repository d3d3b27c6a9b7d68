// The f32 flash backward's k-block kernel for Hopper (sm_90a) on TF32 wgmma:
// flash_bwd_kv_tf32_kernel<DP, MODE, FUSED>, `dot` and `l2` scores, shared by
// flash_attn_bwd_dkv_f32.cu (FUSED = false: dK and dV) and
// flash_attn_bwd_fused_f32.cu (FUSED = true: dQ too).  Replaces, at f32
// inputs, the TPU kernels `_flash_bwd_dkv_kernel(_dma)`
// (vitgan_tpu/ops/attention.py:434-504, pallas_call at :727) and
// `_flash_bwd_fused_kernel` (:507-590, pallas_call at :606).
//
// Math (attention.py:280-330, 392-431), as flash_f32.cuh's head note: every
// product TF32 x TF32 with f32 accumulation, each operand rounded to TF32 to
// nearest (the tensor maps are TFLOAT32, so the TMA unit rounds Q, K, V and
// dO as they land; P and dS are rounded with cvt.rna), the softmax, delta,
// dS and the `l2` norms in f32 (|q|^2 and |k|^2 of the landed, rounded rows,
// so that d2 is |q - k|^2 of the rounded rows).
//   S^T = K Q^T, dP^T = V dO^T, P^T = exp(S^T - lse), dS^T = P^T (dP^T - delta),
//   dV += P^T dO, dK += dS^T Q, and FUSED: dQ of the tile = dS K over the
//   block's keys, added over the key blocks in key-block order.
// `l2` gradients: dK = 2 inv (dS^T Q - colsum(dS) k), dQ = 2 inv (dS K -
// rowsum(dS) q); `dot`: inv dS^T Q and inv dS K.
//
// Design.  A block owns KEYS keys of one (batch*head): 128 at DP <= 64, 64
// above (f32 K and V of 128 keys at DP 128 take 128 KB alone), and streams
// the queries TQ a tile (64 at DP <= 64, 32 above).  Warpgroups:
//   0  producer: thread 0 lands K and V once, then each tile's Q and dO, by
//      TMA (3-D TFLOAT32 maps over (d, n, bh): columns past d and rows past n
//      land as zeros) into a ring of L landed stages on full/empty mbarriers;
//      warp 1 stores the tile's LSE (log2 units, +inf past n) and delta
//      beside them; warps 2 and 3 keep the order of dQ's additions (below);
//   1  re-lay: TF32 wgmma reads shared operands K-major only, and Q and dO
//      lie MN-major for dV += P^T dO and dK += dS^T Q (summed over queries).
//      This warpgroup writes each landed Q and dO K-major into a ring of R
//      re-laid stages (d rows of TQ queries), the queries of each 8-wide
//      chunk in the order the accumulator hands P^T and dS^T to the A
//      fragment (query 2u of the chunk at position u, 2u + 1 at u + 4), so
//      that the permutation costs nothing on the consumers' side.  A lane
//      moves a 4 x 4 block (four 16-byte loads, four 16-byte stores); each
//      quarter-warp's eight blocks lie at eight swizzled places on both
//      sides (`relay_block`; tests/test_torch_f32_flash_plan.py models it).
//      FUSED: it first re-lays the block's K the same way, keys in order
//      (K^T, the B of dQ = dS K); `l2`: it also sums |q|^2 of each tile;
//   2+ consumers, 64 keys each: S^T and dP^T on m64n{TQ}k8 with both
//      operands from shared memory as they landed; P^T and dS^T on the
//      accumulators; dV and dK on m64n{DP}k8 with A (P^T, dS^T, rounded)
//      from registers and B from the re-laid stage.  FUSED: both consumer
//      warpgroups write dS (rounded, [query][key] K-major) into one shared
//      buffer, meet at a named barrier, and one warpgroup a tile in turn
//      forms dQ = dS K over the block's keys (m64n{DP}k8, both operands from
//      shared memory; at TQ 32 the buffer's rows past TQ are zeros and their
//      outputs dropped), then adds it in key-block order.
//
// The single pass's dQ order (ops/attention.fused_dq_schedule at f32 models
// it), as flash_attn_bwd.cuh's `dot` kernel: an int32 flag per (batch*head,
// TQ-query tile), zeroed by the entry, counts the key blocks that have added
// the tile; order warp 2 + w waits (ld.acquire) until it reads the block's
// key-block index kb before consumer warpgroup w adds its tiles, and stores
// kb + 1 (st.release) after.  Key block 0 stores its f32 tile, the middle
// ones add theirs with vector RED, the last reads the sum, adds its own,
// scales and stores dQ; every dQ element is t0 + t1 + ... in key-block
// order, so dQ is bit-deterministic, as dK and dV are.  Each block's place
// is its ticket (atomicAdd on the int32 after the flags), decoded in groups
// of GROUP_HEADS heads, key block slowest within a group: a block waits only
// on the block GROUP_HEADS indices below it, which took its ticket earlier
// and holds its SM until it finishes, so the launch finishes in any
// dispatch order, and that block is usually some tiles ahead of it.
//
// Shared memory (bytes, Geo::SMEM; at most 232,448 a block): K and V
// 2 KEYS DP 4; FUSED K^T KEYS DP 4 and dS 64 KEYS 4; L landed stages of
// 2 TQ DP 4 and R re-laid stages of the same; the rows, |q|^2 and the
// barriers, and 1 KB to align the 128-byte swizzle.
//   DP 32:  FUSED 176 KB + 3.6 KB (L 4, R 2); dK/dV only 128 KB + 3.6 KB (L 4, R 2)
//   DP 64:  FUSED 224 KB + 2.3 KB (L 2, R 1); dK/dV only 192 KB + 2.6 KB (L 2, R 2)
//   DP 96:  FUSED 208 KB + 2.1 KB (L 3, R 2); dK/dV only 168 KB + 2.1 KB (L 3, R 2)
//   DP 128: FUSED 208 KB + 1.7 KB (L 2, R 1); dK/dV only 192 KB + 1.8 KB (L 2, R 2)
//
// Bound on this card: 4-byte operands at 494.7 TFLOP/s TF32 against 3.35
// TB/s.  At highres128's and highres256p4's shapes (Dh 64, 1,024 to 4,097
// tokens) the products bound it; at the v1 shapes (32 and 50 tokens) the
// bytes, a few microseconds.  Times against the bounds: PERF.md,
// chip_smoke.py [f32 kernels], scripts/kernel_ab.py --f32-flash-bwd.
#pragma once

#include "flash_f32.cuh"
#include "hopper.cuh"

namespace vk {
namespace f32bwd {

using namespace vk::hopper;
using f32::tf32;

constexpr float LOG2E = 1.4426950408889634f;
// FUSED: heads a group of the ticket's order (ops/attention.FUSED_GROUP_HEADS)
constexpr int GROUP_HEADS = 32;
// Named barriers: the consumer warpgroups' dS exchange, the dS buffer freed
// by the last tile's dQ, and GO + w / DONE + w between order warp 2 + w and
// consumer warpgroup w (128 + 32 threads).
constexpr int BAR_DS = 1, BAR_FREE = 2, BAR_GO = 3, BAR_DONE = 5, ORDER_THREADS = 160;

template <int DP, bool FUSED>
struct Geo {
  static_assert(DP % 32 == 0 && DP >= 32 && DP <= 128, "DP: 32, 64, 96 or 128");
  static constexpr int NWG = DP <= 64 ? 2 : 1;        // consumer warpgroups
  static constexpr int KEYS = 64 * NWG;               // keys a block
  static constexpr int TQ = DP <= 64 ? 64 : 32;       // queries a tile
  static constexpr int NB = DP / 32;                  // 32-column boxes of a landed row
  static constexpr int THREADS = 128 * (2 + NWG);
  static constexpr int KBOX = KEYS * 128;             // a landed K or V box
  static constexpr int QBOX = TQ * 128;               // a landed Q or dO box
  static constexpr int LSTAGE = 2 * NB * QBOX;        // Q's boxes, then dO's
  static constexpr int RBOX = DP * 128;               // a re-laid box: DP rows x 32 summed
  static constexpr int RSTAGE = 2 * (TQ / 32) * RBOX; // Q^T's boxes, then dO^T's
  static constexpr int KT = FUSED ? KEYS / 32 * RBOX : 0;
  static constexpr int DSB_BOX = 64 * 128;            // dS: 64 query rows x 32 keys
  static constexpr int DSB = FUSED ? KEYS / 32 * DSB_BOX : 0;
  static constexpr int L = DP == 32 ? 4 : DP == 96 ? 3 : 2;
  static constexpr int R = FUSED && DP % 64 == 0 ? 1 : 2;
  static constexpr int FLOATS = L * 2 * TQ + R * TQ;  // lse2 and delta a landed stage, |q|^2 a re-laid one
  static constexpr int SMEM = 1024 + 2 * NB * KBOX + KT + DSB + L * LSTAGE + R * RSTAGE +
                              FLOATS * 4 + (2 * L + 2 * R + 2) * 8;
  static_assert(SMEM <= 232448, "a block an SM");
};

// The 4 x 4 block a re-lay lane moves in step s of its quarter-warp (lane l
// = lane % 8 of it): position chunk p (summed positions 4 p .. 4 p + 3) and
// column chunk c (columns 4 c .. 4 c + 3), for an operand of `rows` summed
// rows.  PERM (Q, dO): position 4 (2 m + h) + j holds query 8 m + 2 j + h;
// else (K) position i holds key i.  Chosen so that each quarter-warp's eight
// loads (landed chunk (c ^ row) % 8) and eight stores (re-laid chunk (p ^ c4
// + ii) % 8) fall on eight different 16-byte places of a 128-byte row.
template <int DP, int ROWS, bool PERM>
__device__ inline void relay_block(int s, int l, int& p, int& c) {
  constexpr int PG = ROWS / 32;  // groups of eight position chunks
  p = 8 * (s % PG) + l;
  const int c0 = s / PG;
  c = PERM ? (c0 ^ (l & 6)) : (c0 ^ l);
}

// Re-lay `src` (ROWS summed rows of DP columns, landed as DP / 32 swizzled
// boxes of ROWS x 32) K-major into `dst` (DP rows of ROWS summed positions,
// ROWS / 32 swizzled boxes of DP x 32), this warpgroup's share (qw: the
// quarter-warp, l: its lane).  The bits are moved as they are (TMA rounded
// them).
template <int DP, int ROWS, bool PERM>
__device__ inline void relay(const unsigned char* src, unsigned char* dst, int qw, int l) {
  constexpr int STEPS = ROWS / 32 * (DP / 4);
#pragma unroll 1
  for (int s = qw; s < STEPS; s += 16) {
    int p, c;
    relay_block<DP, ROWS, PERM>(s, l, p, c);
    float4 v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = PERM ? 8 * (p >> 1) + 2 * j + (p & 1) : 4 * p + j;
      v[j] = *reinterpret_cast<const float4*>(src + (c >> 3) * ROWS * 128 + r * 128 +
                                              (((c & 7) ^ (r & 7)) << 4));
    }
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      const int i = 4 * c + ii;
      const float4 o = ii == 0   ? make_float4(v[0].x, v[1].x, v[2].x, v[3].x)
                       : ii == 1 ? make_float4(v[0].y, v[1].y, v[2].y, v[3].y)
                       : ii == 2 ? make_float4(v[0].z, v[1].z, v[2].z, v[3].z)
                                 : make_float4(v[0].w, v[1].w, v[2].w, v[3].w);
      *reinterpret_cast<float4*>(dst + (p >> 3) * DP * 128 + i * 128 +
                                 (((p & 7) ^ (i & 7)) << 4)) = o;
    }
  }
}

// Byte offset of columns col, col + 1 (col even) of row r in a landed operand
// of `rows` rows (32-column boxes of rows x 128 bytes, 128-byte swizzle).
__device__ inline int landed_pair(int rows, int r, int col) {
  return (col >> 5) * rows * 128 + r * 128 + ((((col & 31) >> 2) ^ (r & 7)) << 4) + 4 * (col & 3);
}

// Sum of squares of row r of a landed operand, over the column chunks c =
// part, part + parts, ... (the caller adds the parts).
template <int DP>
__device__ inline float row_sq(const unsigned char* x, int rows, int r, int part, int parts) {
  float s = 0.f;
  for (int c = part; c < DP / 4; c += parts) {
    const float4 v = *reinterpret_cast<const float4*>(x + (c >> 3) * rows * 128 + r * 128 +
                                                      (((c & 7) ^ (r & 7)) << 4));
    s += v.x * v.x + v.y * v.y + v.z * v.z + v.w * v.w;
  }
  return s;
}

template <int DP, int MODE, bool FUSED>
__global__ void __launch_bounds__(Geo<DP, FUSED>::THREADS, 1)
flash_bwd_kv_tf32_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tdo,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv,
                         float* __restrict__ dq_acc, float* __restrict__ dq,
                         uint32_t* __restrict__ dq_order, int n, int d, float scale_log2,
                         float inv_scale) {
  using G = Geo<DP, FUSED>;
  constexpr int NWG = G::NWG, KEYS = G::KEYS, TQ = G::TQ, NB = G::NB, L = G::L, R = G::R;
  constexpr int NA = DP / 2, NS = TQ / 2;  // accumulator floats a thread: dK/dV/dQ, S^T/dP^T
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ks = align1024(smem_raw);
  unsigned char* vs = ks + NB * G::KBOX;
  unsigned char* kt = vs + NB * G::KBOX;       // FUSED: K^T re-laid
  unsigned char* dsb = kt + G::KT;             // FUSED: dS [query][key]
  unsigned char* landed = dsb + G::DSB;        // stage s at s LSTAGE: Q's boxes, dO's
  unsigned char* relaid = landed + L * G::LSTAGE;  // stage s at s RSTAGE: Q^T's boxes, dO^T's
  float* rows = reinterpret_cast<float*>(relaid + R * G::RSTAGE);  // stage s: lse2, delta
  float* qn = rows + L * 2 * TQ;                                   // |q|^2 a re-laid stage
  uint64_t* lfull = reinterpret_cast<uint64_t*>(qn + R * TQ);
  uint64_t* lempty = lfull + L;
  uint64_t* rfull = lempty + L;
  uint64_t* rempty = rfull + R;
  uint64_t* kvbar = rempty + R;
  uint64_t* ktbar = kvbar + 1;

  __shared__ int order_index;
  const int wgi = threadIdx.x >> 7, lane = threadIdx.x & 31;
  const int nkb = (n + KEYS - 1) / KEYS, ntiles = (n + TQ - 1) / TQ;
  if (threadIdx.x == 0) {
    for (int s = 0; s < L; ++s) {
      mbar_init(&lfull[s], 33);            // thread 0 (with the TMA bytes), warp 1's lanes
      mbar_init(&lempty[s], 4 + 4 * NWG);  // the re-lay warps and the consumer warps
    }
    for (int s = 0; s < R; ++s) {
      mbar_init(&rfull[s], 4);             // the re-lay warps
      mbar_init(&rempty[s], NWG);          // the consumer warpgroups
    }
    mbar_init(kvbar, 1);
    mbar_init(ktbar, 4);
    mbar_fence_init();
    if (FUSED)
      order_index = nkb > 1 ? (int)atomicAdd(dq_order + (long)(gridDim.x / nkb) * ntiles, 1u)
                            : (int)blockIdx.x;
  }
  __syncthreads();
  int kb = blockIdx.x, bh = blockIdx.y;
  if constexpr (FUSED) {  // the grouped order of the ticket (the head note)
    const int span = nkb * GROUP_HEADS, group = order_index / span, base = group * GROUP_HEADS;
    const int gh = min(GROUP_HEADS, (int)(gridDim.x / nkb) - base);
    const int r = order_index - group * span;
    kb = r / gh;
    bh = base + r % gh;
  }
  const int k0 = kb * KEYS;

  if (wgi == 0) {
    reg_dealloc<40>();
    if (threadIdx.x == 0) {  // TMA: K and V once, then Q and dO a tile
      mbar_arrive_tx(kvbar, 2 * NB * G::KBOX);
      for (int b = 0; b < NB; ++b) {
        tma_load_3d(ks + b * G::KBOX, &tk, kvbar, 32 * b, k0, bh);
        tma_load_3d(vs + b * G::KBOX, &tv, kvbar, 32 * b, k0, bh);
      }
      for (int qt = 0; qt < ntiles; ++qt) {
        const int s = qt % L;
        if (qt >= L) mbar_wait(&lempty[s], ((qt / L) - 1) & 1);
        unsigned char* st = landed + s * G::LSTAGE;
        mbar_arrive_tx(&lfull[s], G::LSTAGE);
        for (int b = 0; b < NB; ++b) {
          tma_load_3d(st + b * G::QBOX, &tq, &lfull[s], 32 * b, qt * TQ, bh);
          tma_load_3d(st + (NB + b) * G::QBOX, &tdo, &lfull[s], 32 * b, qt * TQ, bh);
        }
      }
    } else if ((threadIdx.x >> 5) == 1) {
      // lse in log2 units (+inf past n) and delta (0 past n), TQ / 32 rows a
      // lane, the next tile's loads in flight while this one's are stored
      const float* lseb = lse + (long)bh * n;
      const float* deltab = delta + (long)bh * n;
      auto fetch = [&](int qt, float (&v)[4]) {
#pragma unroll
        for (int h = 0; h < TQ / 32; ++h) {
          const int r = qt * TQ + lane + 32 * h;
          v[h] = r < n ? lseb[r] * LOG2E : INFINITY;
          v[2 + h] = r < n ? deltab[r] : 0.f;
        }
      };
      float cur[4], nxt[4];
      fetch(0, cur);
      for (int qt = 0; qt < ntiles; ++qt) {
        const int s = qt % L;
        if (qt + 1 < ntiles) fetch(qt + 1, nxt);
        if (qt >= L) mbar_wait(&lempty[s], ((qt / L) - 1) & 1);
        float* rw = rows + s * 2 * TQ;
#pragma unroll
        for (int h = 0; h < TQ / 32; ++h) {
          rw[lane + 32 * h] = cur[h];
          rw[TQ + lane + 32 * h] = cur[2 + h];
        }
        mbar_arrive(&lfull[s]);
#pragma unroll
        for (int i = 0; i < 4; ++i) cur[i] = nxt[i];
      }
    } else if (FUSED && (threadIdx.x >> 5) - 2 < NWG && nkb > 1) {
      // the order of dQ's additions: warp 2 + w keeps it for consumer
      // warpgroup w, which adds the dQ of tiles qt = w, w + NWG, ...: it adds
      // once key block kb - 1 has, and key block kb + 1 may add once it has
      const int w = (threadIdx.x >> 5) - 2;
      uint32_t* flags = dq_order + (long)bh * ntiles;
      for (int qt = w; qt < ntiles; qt += NWG) {
        if (kb > 0) {
          if (lane == 0)
            while (ld_acquire_gpu(flags + qt) < (uint32_t)kb) {
            }
          __syncwarp();
          named_bar_sync(BAR_GO + w, ORDER_THREADS);
        }
        if (kb < nkb - 1) {
          named_bar_sync(BAR_DONE + w, ORDER_THREADS);
          if (lane == 0) st_release_gpu(flags + qt, kb + 1);
        }
      }
    }
    return;
  }

  if (wgi == 1) {  // the re-lay warpgroup
    reg_dealloc<64>();
    const int qw = (threadIdx.x & 127) >> 3, l = lane & 7;
    if constexpr (FUSED) {  // K^T, keys in order: the B of dQ = dS K
      mbar_wait(kvbar, 0);
      relay<DP, KEYS, false>(ks, kt, qw, l);
      fence_proxy_async();
      __syncwarp();
      if (lane == 0) mbar_arrive(ktbar);
    }
    for (int qt = 0; qt < ntiles; ++qt) {
      const int sl = qt % L, sr = qt % R;
      mbar_wait(&lfull[sl], (qt / L) & 1);
      if (qt >= R) mbar_wait(&rempty[sr], ((qt / R) - 1) & 1);
      const unsigned char* src = landed + sl * G::LSTAGE;
      unsigned char* dst = relaid + sr * G::RSTAGE;
      relay<DP, TQ, true>(src, dst, qw, l);
      relay<DP, TQ, true>(src + NB * G::QBOX, dst + TQ / 32 * G::RBOX, qw, l);
      if constexpr (MODE != kDot) {  // |q|^2 of the tile's rows, 128 / TQ lanes a row
        constexpr int PARTS = 128 / TQ;
        const int tt = threadIdx.x & 127, r = tt / PARTS;
        float sq = row_sq<DP>(src, TQ, r, tt % PARTS, PARTS);
#pragma unroll
        for (int o = 1; o < PARTS; o <<= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
        if (tt % PARTS == 0) qn[sr * TQ + r] = sq;
      }
      fence_proxy_async();  // the re-laid values, to the consumers' wgmma reads
      __syncwarp();
      if (lane == 0) {
        mbar_arrive(&lempty[sl]);
        mbar_arrive(&rfull[sr]);
      }
    }
    return;
  }

  // consumers: warpgroup w owns keys k0 + 64 w .. + 63
  reg_alloc<NWG == 2 ? 200 : 240>();
  const int w = wgi - 2, ct = threadIdx.x & 127, wr = ct >> 5, g = lane >> 2, t = lane & 3;
  const unsigned char* kw = ks + w * 64 * 128;  // the warpgroup's keys in each K box
  const unsigned char* vw = vs + w * 64 * 128;
  float dka[NA], dva[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) dka[i] = dva[i] = 0.f;
  float kk[2] = {0.f, 0.f}, cs[2] = {0.f, 0.f};
  if constexpr (FUSED && TQ < 64) {  // dS rows past TQ: zeros, their dQ rows dropped
    for (int i = ct; i < KEYS / 32 * (64 - TQ) * 8; i += 128) {
      const int box = i / ((64 - TQ) * 8), rest = i % ((64 - TQ) * 8);
      *reinterpret_cast<float4*>(dsb + box * G::DSB_BOX + TQ * 128 + rest * 16) =
          make_float4(0.f, 0.f, 0.f, 0.f);
    }
    fence_proxy_async();
  }
  mbar_wait(kvbar, 0);
  if constexpr (MODE != kDot) {  // |k|^2 of this thread's keys, the four lanes t a quarter each
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float sq = row_sq<DP>(ks, KEYS, 64 * w + 16 * wr + g + 8 * h, t, 4);
      sq += __shfl_xor_sync(0xffffffffu, sq, 1);
      sq += __shfl_xor_sync(0xffffffffu, sq, 2);
      kk[h] = sq;
    }
  }

  for (int qt = 0; qt < ntiles; ++qt) {
    const int sl = qt % L, sr = qt % R;
    const bool dq_here = FUSED && w == qt % NWG;
    mbar_wait(&lfull[sl], (qt / L) & 1);
    const unsigned char* qs = landed + sl * G::LSTAGE;
    const unsigned char* dos = qs + NB * G::QBOX;
    // S^T = K Q^T and dP^T = V dO^T (64 keys x TQ queries), one group each;
    // the first step overwrites the accumulators
    float sa[NS], pa[NS];
    wgmma_fence();
#pragma unroll
    for (int k8 = 0; k8 < DP / 8; ++k8)
      wgmma_tf32_ss<TQ>(sa, desc_sw128(kw + (k8 >> 2) * G::KBOX + (k8 & 3) * 32, 16, 1024),
                        desc_sw128(qs + (k8 >> 2) * G::QBOX + (k8 & 3) * 32, 16, 1024), k8 > 0);
    wgmma_commit();
#pragma unroll
    for (int k8 = 0; k8 < DP / 8; ++k8)
      wgmma_tf32_ss<TQ>(pa, desc_sw128(vw + (k8 >> 2) * G::KBOX + (k8 & 3) * 32, 16, 1024),
                        desc_sw128(dos + (k8 >> 2) * G::QBOX + (k8 & 3) * 32, 16, 1024), k8 > 0);
    wgmma_commit();
    const unsigned char* rs = relaid + sr * G::RSTAGE;  // Q^T's boxes, then dO^T's
    if constexpr (MODE != kDot) mbar_wait(&rfull[sr], (qt / R) & 1);  // |q|^2
    wgmma_wait<1>();  // S
    fence_regs(sa);
    // P^T in place: this thread holds keys 16 wr + g + 8 (e >> 1) of the
    // warpgroup, queries 8 j + 2 t + (e & 1) of the tile
    const float* lse2 = rows + sl * 2 * TQ;
    const float* dl = lse2 + TQ;
#pragma unroll
    for (int j = 0; j < TQ / 8; ++j) {
      const int col = 8 * j + 2 * t;
      const float2 lq = *reinterpret_cast<const float2*>(lse2 + col);
      float2 qq = make_float2(0.f, 0.f);
      if constexpr (MODE != kDot) qq = *reinterpret_cast<const float2*>(qn + sr * TQ + col);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 64 * w + 16 * wr + g + 8 * (e >> 1);
        const bool ok = key < n && qt * TQ + col + (e & 1) < n;
        sa[4 * j + e] =
            ok ? exp2f(score_log2<MODE>(sa[4 * j + e], (e & 1) ? qq.y : qq.x, kk[e >> 1],
                                        scale_log2) -
                       ((e & 1) ? lq.y : lq.x))
               : 0.f;
      }
    }
    // dV += P^T dO: A the rounded P^T (a k8 step's fragment: columns 2t, 2t + 1
    // of the accumulator chunk at t, t + 4, as the re-laid rows lie), B dO^T
    uint32_t pf[TQ / 8][4], df[TQ / 8][4];
#pragma unroll
    for (int j = 0; j < TQ / 8; ++j) {
      pf[j][0] = tf32(sa[4 * j]);
      pf[j][1] = tf32(sa[4 * j + 2]);
      pf[j][2] = tf32(sa[4 * j + 1]);
      pf[j][3] = tf32(sa[4 * j + 3]);
    }
    if constexpr (MODE == kDot) mbar_wait(&rfull[sr], (qt / R) & 1);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < TQ / 8; ++j)
      wgmma_tf32_rs<DP>(dva, pf[j],
                        desc_sw128(rs + (TQ / 32 + (j >> 2)) * G::RBOX + (j & 3) * 32, 16, 1024),
                        1);
    wgmma_commit();
    wgmma_wait<1>();  // dP
    fence_regs(pa);
    // dS^T = P^T (dP^T - delta) in place, from the unrounded P
#pragma unroll
    for (int j = 0; j < TQ / 8; ++j) {
      const float2 dd = *reinterpret_cast<const float2*>(dl + 8 * j + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        pa[4 * j + e] = sa[4 * j + e] * (pa[4 * j + e] - ((e & 1) ? dd.y : dd.x));
        if constexpr (MODE != kDot) cs[e >> 1] += pa[4 * j + e];
      }
    }
    if constexpr (FUSED) {
      // dS rounded into the shared buffer, [query][key] K-major (32-key boxes)
      if (NWG > 1 && qt > 0) named_bar_sync(BAR_FREE, 128 * NWG);  // the last tile's dQ read it
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int kr = 64 * w + 16 * wr + g + 8 * h;
        unsigned char* col = dsb + (kr >> 5) * G::DSB_BOX + 4 * (kr & 3);
        const int chunk = (kr & 31) >> 2;
#pragma unroll
        for (int j = 0; j < TQ / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int qi = 8 * j + 2 * t + e;
            *reinterpret_cast<uint32_t*>(col + qi * 128 + ((chunk ^ (qi & 7)) << 4)) =
                tf32(pa[4 * j + 2 * h + e]);
          }
      }
    }
#pragma unroll
    for (int j = 0; j < TQ / 8; ++j) {
      df[j][0] = tf32(pa[4 * j]);
      df[j][1] = tf32(pa[4 * j + 2]);
      df[j][2] = tf32(pa[4 * j + 1]);
      df[j][3] = tf32(pa[4 * j + 3]);
    }
    // the landed stage is free (the dQ warpgroup's `l2` dQ still reads Q)
    if (!(dq_here && MODE != kDot)) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&lempty[sl]);
    }
    // dK += dS^T Q (B: Q^T)
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < TQ / 8; ++j)
      wgmma_tf32_rs<DP>(dka, df[j], desc_sw128(rs + (j >> 2) * G::RBOX + (j & 3) * 32, 16, 1024),
                        1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_frags(pf);
    fence_frags(df);
    if (ct == 0) mbar_arrive(&rempty[sr]);

    if constexpr (FUSED) {
      // dQ of the tile = dS K over the block's keys, by one warpgroup a tile
      // in turn, added in key-block order
      fence_proxy_async();
      named_bar_sync(BAR_DS, 128 * NWG);
      if (dq_here) {
        if (qt < NWG) mbar_wait(ktbar, 0);
        float qa[NA];
        wgmma_fence();
#pragma unroll
        for (int k8 = 0; k8 < KEYS / 8; ++k8)
          wgmma_tf32_ss<DP>(qa, desc_sw128(dsb + (k8 >> 2) * G::DSB_BOX + (k8 & 3) * 32, 16, 1024),
                            desc_sw128(kt + (k8 >> 2) * G::RBOX + (k8 & 3) * 32, 16, 1024),
                            k8 > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(qa);
        if constexpr (MODE != kDot) {
          // dS K - rowsum(dS) q: the block's rowsum of the rounded dS (the
          // four lanes t two chunks a box each), q from the landed tile
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int lr = 16 * wr + g + 8 * h;
            float rsum = 0.f;
#pragma unroll
            for (int b = 0; b < KEYS / 32; ++b)
#pragma unroll
              for (int cc = t; cc < 8; cc += 4) {
                const float4 x = *reinterpret_cast<const float4*>(
                    dsb + b * G::DSB_BOX + lr * 128 + ((cc ^ (lr & 7)) << 4));
                rsum += (x.x + x.y) + (x.z + x.w);
              }
            rsum += __shfl_xor_sync(0xffffffffu, rsum, 1);
            rsum += __shfl_xor_sync(0xffffffffu, rsum, 2);
            if (lr < TQ) {
#pragma unroll
              for (int j = 0; j < DP / 8; ++j) {
                const float2 x =
                    *reinterpret_cast<const float2*>(qs + landed_pair(TQ, lr, 8 * j + 2 * t));
                qa[4 * j + 2 * h] -= rsum * x.x;
                qa[4 * j + 2 * h + 1] -= rsum * x.y;
              }
            }
          }
          __syncwarp();
          if (lane == 0) mbar_arrive(&lempty[sl]);
        }
        // lanes t and t ^ 1 swap halves: even t takes row g, odd t row g + 8,
        // four columns 8 j + 4 (t >> 1) .. + 3 each
        float4 v[DP / 8];
#pragma unroll
        for (int j = 0; j < DP / 8; ++j) {
          const float x0 = (t & 1) ? qa[4 * j] : qa[4 * j + 2];
          const float x1 = (t & 1) ? qa[4 * j + 1] : qa[4 * j + 3];
          const float y0 = __shfl_xor_sync(0xffffffffu, x0, 1);
          const float y1 = __shfl_xor_sync(0xffffffffu, x1, 1);
          v[j] = (t & 1) ? make_float4(y0, y1, qa[4 * j + 2], qa[4 * j + 3])
                         : make_float4(qa[4 * j], qa[4 * j + 1], y0, y1);
        }
        const int lr = 16 * wr + g + ((t & 1) ? 8 : 0), row = qt * TQ + lr;
        const bool in_row = lr < TQ && row < n;
        const long off = ((long)bh * n + row) * d + 4 * (t >> 1);
        if (nkb > 1 && kb > 0) named_bar_sync(BAR_GO + w, ORDER_THREADS);  // kb - 1 has added
        if (kb == nkb - 1) {  // the last key block finishes dQ: the sum, its own, scaled
          if (nkb > 1) {  // eight loads in flight at once, then their adds
            constexpr int GL = DP / 8 < 8 ? DP / 8 : 8;
#pragma unroll
            for (int j0 = 0; j0 < DP / 8; j0 += GL) {
              float4 a[GL];
#pragma unroll
              for (int i = 0; i < GL; ++i)
                a[i] = in_row && 8 * (j0 + i) + 4 * (t >> 1) < d
                           ? __ldcg(reinterpret_cast<const float4*>(dq_acc + off + 8 * (j0 + i)))
                           : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
              for (int i = 0; i < GL; ++i)
                v[j0 + i] = make_float4(a[i].x + v[j0 + i].x, a[i].y + v[j0 + i].y,
                                        a[i].z + v[j0 + i].z, a[i].w + v[j0 + i].w);
            }
          }
          const float sc = MODE == kDot ? inv_scale : 2.f * inv_scale;
#pragma unroll
          for (int j = 0; j < DP / 8; ++j)
            if (in_row && 8 * j + 4 * (t >> 1) < d)
              *reinterpret_cast<float4*>(dq + off + 8 * j) =
                  make_float4(sc * v[j].x, sc * v[j].y, sc * v[j].z, sc * v[j].w);
        } else if (kb == 0) {
#pragma unroll
          for (int j = 0; j < DP / 8; ++j)
            if (in_row && 8 * j + 4 * (t >> 1) < d)
              __stcg(reinterpret_cast<float4*>(dq_acc + off + 8 * j), v[j]);
        } else {
#pragma unroll
          for (int j = 0; j < DP / 8; ++j)
            if (in_row && 8 * j + 4 * (t >> 1) < d)
              atomicAdd(reinterpret_cast<float4*>(dq_acc + off + 8 * j), v[j]);
        }
        if (kb < nkb - 1) named_bar_sync(BAR_DONE + w, ORDER_THREADS);  // kb + 1 may add
      }
    }
  }

  fence_regs(dva);
  fence_regs(dka);
  // dK and dV: keys < n, columns < d
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if constexpr (MODE != kDot) {
      cs[h] += __shfl_xor_sync(0xffffffffu, cs[h], 1);
      cs[h] += __shfl_xor_sync(0xffffffffu, cs[h], 2);
    }
    const int kl = 64 * w + 16 * wr + g + 8 * h, key = k0 + kl;
    if (key >= n) continue;
    const long off = ((long)bh * n + key) * d;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = 8 * j + 2 * t;  // d is a multiple of 4: col + 1 < d too
      if (col >= d) continue;
      float2 r;
      if constexpr (MODE == kDot) {
        r = make_float2(inv_scale * dka[4 * j + 2 * h], inv_scale * dka[4 * j + 2 * h + 1]);
      } else {
        const float2 x = *reinterpret_cast<const float2*>(ks + landed_pair(KEYS, kl, col));
        r = make_float2(2.f * inv_scale * (dka[4 * j + 2 * h] - cs[h] * x.x),
                        2.f * inv_scale * (dka[4 * j + 2 * h + 1] - cs[h] * x.y));
      }
      *reinterpret_cast<float2*>(dk + off + col) = r;
      *reinterpret_cast<float2*>(dv + off + col) =
          make_float2(dva[4 * j + 2 * h], dva[4 * j + 2 * h + 1]);
    }
  }
}

// One launch of the kernel for head width d (DP: d rounded up to 32) on
// (bh, n, d) f32 tensors; FUSED zeroes the flags and the ticket first where
// a head has more than one key block.
template <int DP, int MODE, bool FUSED>
int launch(const void* q, const void* k, const void* v, const void* dout, const void* lse,
           const void* delta, void* dk, void* dv, void* dq_acc, void* dq, void* dq_order, int bh,
           int n, int d, float inv_scale, cudaStream_t stream) {
  using G = Geo<DP, FUSED>;
  const int nkb = (n + G::KEYS - 1) / G::KEYS, ntiles = (n + G::TQ - 1) / G::TQ;
  if (FUSED && nkb > 1) {
    if (dq_acc == nullptr || dq_order == nullptr) return (int)cudaErrorInvalidValue;
    const cudaError_t err =
        cudaMemsetAsync(dq_order, 0, ((long)bh * ntiles + 1) * sizeof(uint32_t), stream);
    if (err != cudaSuccess) return (int)err;
  }
  CUtensorMap tq{}, tk{}, tv{}, tdo{};
  int err = tmap_3d_tf32(&tq, q, bh, n, d, G::TQ);
  if (!err) err = tmap_3d_tf32(&tdo, dout, bh, n, d, G::TQ);
  if (!err) err = tmap_3d_tf32(&tk, k, bh, n, d, G::KEYS);
  if (!err) err = tmap_3d_tf32(&tv, v, bh, n, d, G::KEYS);
  if (err) return err;
  auto kernel = flash_bwd_kv_tf32_kernel<DP, MODE, FUSED>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  if (e != cudaSuccess) return (int)e;
  // FUSED: one dimension in the ticket's grouped order; else (key blocks, heads)
  const dim3 grid = FUSED ? dim3(nkb * bh) : dim3(nkb, bh);
  kernel<<<grid, G::THREADS, G::SMEM, stream>>>(
      tq, tk, tv, tdo, static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv), static_cast<float*>(dq_acc),
      static_cast<float*>(dq), static_cast<uint32_t*>(dq_order), n, d, inv_scale * LOG2E,
      inv_scale);
  return (int)cudaGetLastError();
}

// The entries' dispatch: the instantiation for d (a multiple of 4, 4 <= d <=
// 128) and mode (0 `dot`, 1 `l2`); cudaErrorInvalidValue for any other.
template <bool FUSED>
int dispatch(const void* q, const void* k, const void* v, const void* dout, const void* lse,
             const void* delta, void* dk, void* dv, void* dq_acc, void* dq, void* dq_order,
             int bh, int n, int d, float inv_scale, int mode, cudaStream_t s) {
  if (!f32::shape_ok(bh, n, d) || (mode != kDot && mode != kL2)) return (int)cudaErrorInvalidValue;
  return f32::by_width(d, [&](auto dp) {
    constexpr int DP = decltype(dp)::value;
    return mode == kDot ? launch<DP, kDot, FUSED>(q, k, v, dout, lse, delta, dk, dv, dq_acc, dq,
                                                  dq_order, bh, n, d, inv_scale, s)
                        : launch<DP, kL2, FUSED>(q, k, v, dout, lse, delta, dk, dv, dq_acc, dq,
                                                 dq_order, bh, n, d, inv_scale, s);
  });
}

}  // namespace f32bwd
}  // namespace vk
