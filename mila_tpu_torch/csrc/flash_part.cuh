// The block plan of the flash-attention forward past D 256, shared by its
// two kernels: flash_fwd.cu's flash_fwd_part_kernel (bf16, fp16 past D 320;
// at D 320 itself flash_fwd_wide_kernel runs) and flash_tf32_fwd.cu's
// fwd_part_kernel (f32 on tf32 wgmma). A block takes 64
// query rows and one column part of O, at most 512 columns: all of them up
// to D 512, past it parts of DC_SMALL or DC_LARGE columns (dcmax_of, the
// f32 backward's rule too). Two consumer
// warpgroups each form the whole S = Q K^T of a key tile (over all D
// columns, once a tile and part) and each owns half of the part's columns of
// O: 64 rows x DC / 2 columns of f32, 128 registers a thread at 512. Q sits
// in shared memory for the whole block when it fits beside one K and one V
// stage ("resident"); else Q and K stream together in chunks of one 128-byte
// panel (64 bf16 or 32 f32 columns), each chunk a job of the K ring.
// kernels/flash_attention.py:plan_wide mirrors plan() below, and the CPU
// tests hold the mirror to these rules.
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

// One call's arguments as the kernels take them.
struct Args {
  int Tq, Tkv, NH, NKV, D;
  float sm_scale;
  int kv_offset, causal;
  Plan p;
};

}  // namespace fpart
}  // namespace
