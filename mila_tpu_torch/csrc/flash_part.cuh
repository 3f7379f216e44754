// The block plans of flash attention past D 256. plan(): the forward's,
// shared by its two kernels: flash_fwd.cu's flash_fwd_part_kernel (bf16, fp16
// past D 320; at D 320 itself flash_fwd_wide_kernel runs) and
// flash_tf32_fwd.cu's fwd_part_kernel (f32 on tf32 wgmma). A block takes 64
// query rows and one column part of O, at most 512 columns: all of them up
// to D 512, past it parts of DC_SMALL or DC_LARGE columns (dcmax_of, the
// f32 backward's rule too). Two consumer
// warpgroups each form the whole S = Q K^T of a key tile (over all D
// columns, once a tile and part) and each owns half of the part's columns of
// O: 64 rows x DC / 2 columns of f32, 128 registers a thread at 512. Q sits
// in shared memory for the whole block when it fits beside one K and one V
// stage ("resident"); else Q and K stream together in chunks of one 128-byte
// panel (64 bf16 or 32 f32 columns), each chunk a job of the K ring.
// plan_bwd(): the 16-bit backward's (flash_bwd.cu: flash_bwd_dq_part_kernel
// and flash_bwd_dkv_part_kernel), below.
// kernels/flash_attention.py:plan_wide and plan_bwd mirror plan() and
// plan_bwd(), and the CPU tests hold the mirrors to these rules.
#pragma once

namespace {
namespace fpart {

constexpr int BQ = 64;           // query rows a block
constexpr int THREADS = 256;     // two consumer warpgroups, no producer warp
constexpr int ISSUER = 128;      // thread 0 of warpgroup 1 issues the TMA loads
constexpr int SCHED = 1;         // named barriers SCHED + wg: warpgroup wg's turn
constexpr int ROUNDED = 3;       // named barrier: Q rounded to tf32 (f32)
constexpr int SMEM_LIMIT = 232448;
constexpr int MAX_STAGES = 3;    // per ring, Q resident
constexpr int STREAM_K = 4, STREAM_V = 2;  // ring stages, Q streamed
constexpr int DC_SMALL = 320, DC_LARGE = 512;

// The widest part a kernel is built for at head size D: DC_SMALL or
// DC_LARGE, the fewer parts, then the narrower. The forward's and the f32
// backward's column parts (flash_sync_bwd.cu: split) both follow it.
__host__ __device__ constexpr int dcmax_of(int D) {
  return (D + DC_LARGE - 1) / DC_LARGE < (D + DC_SMALL - 1) / DC_SMALL ? DC_LARGE : DC_SMALL;
}

// The forward's columns a part: D itself up to DC_LARGE, dcmax_of(D) past it.
__host__ __device__ constexpr int dc_of(int D) { return D <= DC_LARGE ? D : dcmax_of(D); }

struct Plan {
  int dc, parts;      // a part's columns (the last part may hold fewer), parts a head
  int dcmax, bk;      // the kernel built for parts up to dcmax columns; keys a tile
  int q_res, chunk;   // Q resident (chunk = D) or streamed in chunks of `chunk` columns
  int nk, nv;         // stages of the K ring (K tiles, or Q and K chunks) and V ring
  int q_bytes, k_slot, v_slot, smem;
};

// The columns a V stage holds: each warpgroup's products span the widest
// part's half (16-bit: rounded up to whole 64-column panels) from its first
// column, whatever the part's own width, so that no product depends on it
// (a product in a branch would make ptxas serialize every wgmma); the
// columns past the part's compute values that are never stored.
__host__ __device__ constexpr int v_cols(int dcmax, int es) {
  return es == 4 ? dcmax : 128 * ((dcmax + 127) / 128);
}

// es: bytes an element (2: bf16/fp16, 4: f32). Key tiles: 64 keys at parts
// up to 320 columns and 32 past it in 16-bit, 16 in f32 (V^T's 64-byte rows).
// The rings take the most stages (at most MAX_STAGES each, K's one ahead of
// V's at most) that fit beside the resident Q.
inline Plan plan(int D, int es) {
  Plan p{};
  p.dc = dc_of(D);
  p.parts = (D + p.dc - 1) / p.dc;
  p.dcmax = dcmax_of(D);
  p.bk = es == 4 ? 16 : p.dcmax == DC_SMALL ? 64 : 32;
  p.v_slot = p.bk * v_cols(p.dcmax, es) * es;
  const int q = BQ * D * es, k = p.bk * D * es;
  auto bytes = [&](int qb, int ks, int nk, int nv) {
    return qb + nk * ks + nv * p.v_slot + 1024 + (2 * nk + 2 * nv + 1) * 8;
  };
  for (int nk = MAX_STAGES; nk >= 1 && !p.q_res; --nk)
    for (int nv = nk; nv >= nk - 1 && nv >= 1; --nv)
      if (bytes(q, k, nk, nv) <= SMEM_LIMIT) {
        p.q_res = 1, p.nk = nk, p.nv = nv;
        break;
      }
  if (p.q_res) {
    p.chunk = D, p.q_bytes = q, p.k_slot = k;
  } else {
    p.chunk = 128 / es, p.q_bytes = 0, p.k_slot = (BQ + p.bk) * 128;
    p.nk = STREAM_K, p.nv = STREAM_V;
  }
  p.smem = bytes(p.q_bytes, p.k_slot, p.nk, p.nv);
  return p;
}

// The 16-bit backward past D 256. Both kernels take 64 rows (dQ: queries,
// dK/dV: keys) and one column part of their output, and two consumer
// warpgroups share each tile: warpgroup 0 forms S (dK/dV: S^T) and P over
// all D columns, warpgroup 1 dP (dP^T) and dS, once a tile and part, and
// they hand P and T(dS) to each other through shared memory (BWD_XCHG).
// Each then adds into its own half of the part's columns: dQ parts as the
// forward's (dc_of; BWD_OP panels a warpgroup's products span), dK/dV parts
// of BWD_KV_DC columns (64 + 64 registers a thread of dK and dV). One
// producer warp streams every operand through a ring of jobs, each two
// 64-row panels of 64 columns (BWD_SLOT), one for each warpgroup: the other
// side's panels of S and dP (dQ: K and V; dK/dV: Q and dO), then the
// part's columns of the accumulated products' second operand (dQ: K;
// dK/dV: dO, then Q), read again from L2. The block's own operands of S and
// dP (dQ: Q and dO; dK/dV: K and V) sit in shared memory for the whole
// block where they fit beside BWD_MIN_RING jobs ("resident"), else stream as
// jobs of their own before each of the other side's.
constexpr int BWD_SLOT = 2 * 64 * 128;  // a job: two panels of 64 rows x 128 bytes
constexpr int BWD_STATS = 2 * 64 * 4;   // a dK/dV step's lse2 and D, with its last S job
constexpr int BWD_XCHG = 32 * 128 * 4 + 16 * 128 * 4;  // P (f32) and T(dS) handed over
constexpr int BWD_KV_DC = 256;
constexpr int BWD_MIN_RING = 4, BWD_MAX_RING = 8;

// The panels each warpgroup's dQ products span at head size D: half of
// the widest part's, rounded up.
__host__ __device__ constexpr int bwd_op(int D) { return (dcmax_of(D) / 64 + 1) / 2; }

struct PlanBwd {
  int dq_dc, dq_parts;  // dQ's columns a part (the last may hold fewer), parts a head
  int kv_parts;         // dK/dV's parts of BWD_KV_DC columns (the last may hold fewer)
  int res, res_bytes;   // the block's own operands resident (64 rows of two, D columns)
  int ring, smem;       // jobs in the ring; dynamic shared memory, both kernels
};

inline PlanBwd plan_bwd(int D) {
  PlanBwd p{};
  p.dq_dc = dc_of(D);
  p.dq_parts = (D + p.dq_dc - 1) / p.dq_dc;
  p.kv_parts = (D + BWD_KV_DC - 1) / BWD_KV_DC;
  const int stage = BWD_SLOT + BWD_STATS + 16;  // a job, its statistics, its two barriers
  const int fixed = BWD_XCHG + 8 + 1024;        // the resident operands' barrier, alignment
  const int res = 2 * 64 * D * 2;
  int ring = (SMEM_LIMIT - fixed - res) / stage;
  p.res = ring >= BWD_MIN_RING;
  if (p.res)
    p.res_bytes = res;
  else
    ring = (SMEM_LIMIT - fixed) / stage;
  p.ring = ring < BWD_MAX_RING ? ring : BWD_MAX_RING;
  p.smem = p.res_bytes + p.ring * stage + fixed;
  return p;
}

// One call's arguments as the kernels take them.
struct Args {
  int Tq, Tkv, NH, NKV, D;
  float sm_scale;
  int kv_offset, causal;
  Plan p;
};

// The same for the backward's kernels (Tq64: the statistics' padded rows).
struct ArgsBwd {
  int Tq, Tq64, Tkv, NH, NKV, D;
  float sm_scale;
  int kv_offset, causal;
  PlanBwd p;
};

}  // namespace fpart
}  // namespace
