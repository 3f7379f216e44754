// qgemv_int8: decode-shape (M <= 32 rows) one-byte weight stream (int8, or
// fp8 e4m3fn / e5m2) with an optional RMSNorm prologue and a store /
// +residual / SwiGLU / argmax epilogue, on the tensor cores.
//
// Replaces four TPU kernels of mila_tpu/kernels/decode_fused.py:
//   _rms_qmm_kernel        (rms_quant_linear)         prologue rms, epilogue store
//   _qmm_res_kernel        (quant_linear_residual)    no prologue, epilogue +res
//   _rms_qmm_swiglu_kernel (rms_quant_linear_swiglu)  prologue rms, epilogue swiglu
//   _rms_qmm_argmax_kernel (rms_quant_linear_argmax)  prologue rms, epilogue argmax
// Arithmetic as theirs: rstd = rsqrt(mean(x^2) + eps) in f32 over the
// whole row; xs = bf16(x * rstd * gamma), or bf16(x) without the prologue;
// per scale block, (xs @ bf16(q)) summed in f32 and times the block's
// scale row; the epilogue in f32. (The f32 sums run in another order.)
//
// Bound on the H100: the K x N int8 weight bytes (2 M operations per byte).
// A CUDA-core loop (a conversion and M FMAs per byte, about 10
// lane-instructions) is bound by instruction issue long before the bytes
// (the card issues about 9 per byte of its 3.35 TB/s), so the products run
// on mma.sync m16n8k16, with the weight as the 16-row operand (16 output
// columns) and x as the 8-wide one (8 rows of x; M <= 32 takes up to four
// n-tiles): y^T = W^T x^T. The weight is k-major (q [K, ldq]), so each
// bf16x2 register of the A fragment pairs two weight rows of one column.
// Output columns are relabelled inside a warp's 32: lane (g, t) reads the
// 32-bit word of columns 4g..4g+3 from rows 2t, 2t+1, 2t+8 and 2t+9 of a
// 16-row k-step, and byte j of those words is fragment row g + 8 (j & 1) of
// n-tile j >> 1. Each lane then holds, for its rows of x, the outputs of
// its own 4 adjacent columns.
// int8 -> bf16 is exact (every int8 value is a bf16 integer), four
// instructions a pair of bytes (s8_pair): prmt, two lop3 and one bf16x2
// FMA. fp8 -> bf16 is exact too, five a pair (F8Pair, gemv.cuh), and the
// QTensor's scales apply as they are; the TPU kernels' bit decode needs
// its 2^120 / 2^112 scale fixup, this one does not. The format is a launch
// argument and picks the conversion once a stage (a uniform branch around
// the stage's products), so fp8 adds no instantiation. Per int8 weight
// byte: 2 conversion instructions, 0.25 shared loads, and
// the mma and x's fragments about 0.2 more at M 8: about 2.5
// lane-instructions a byte, against the issue budget of about 9. (A first
// version through f32, 2^23 + s + 128 less 2^23 + 128, took 2.75 a byte.)
// A block of 8 warps owns 256 weight columns (SwiGLU: 128 gate columns in
// warps 0-3 and their 128 up columns in warps 4-7) and a slice of kc rows.
// The slice streams through a ring of NST stages of 64 rows x 256 bytes by
// 16-byte cp.async (4-byte copies where the rows are not 16-byte aligned),
// NST - 1 stages in flight; each thread copies the same 16 bytes of every
// row it takes, so a stage's copies cost a few instructions. The first
// stages, gamma's slice and the scale rows are requested before anything
// else, and the launch is a programmatic dependent one: those weight loads
// start under the tail of the kernel before (griddepcontrol), and the
// kernel waits for it only before it reads x and the residual. Then the
// RMSNorm pass, the staging of x's slice (bf16 pairs in the fragment's
// order), and the residual's copies, which land under the stream.
// Measured on the card (PERF.md §6): launch, prologue and epilogue set most
// of the time at the small projections, the loop's instructions the rest;
// 16 warps (splitting each stage's k-steps, or of 2 columns a lane), the
// RMSNorm sums exchanged across the cluster's slices (x read once),
// 32-row stages and 128-column blocks were no faster.
// Each scale window (a scale block, or the whole slice with per-channel
// scales) is summed on its own and scaled at its end. The block's sums go
// to a [rows of x][256] f32 tile in shared memory; with ksplit > 1 slices
// (at most 8) the slices of a column tile run as one thread-block cluster
// and each block stores its partial of every row into the shared memory of
// the block that owns that row, and after one cluster barrier each owner
// adds its rows over the slices, in slice order (no float atomics and no
// workspace, so two calls are bit-equal): one launch in all. The owner
// applies the epilogue: store, + residual, silu(g) u, or the argmax.
// The argmax epilogue never writes logits: each warp reduces 32 columns'
// 64-bit keys (order-preserving bits of the f32 value above the inverted
// column index, so the larger value, then the lower index, wins; padded
// vocab columns are left out) and merges the row's key with one atomicMax.
// The entry point clears the keys on the stream first and turns them into
// indices last, so the call captures into a CUDA graph.
#include "common.cuh"
#include "gemv.cuh"

namespace {

constexpr int WARPS = 8, THREADS = 32 * WARPS;
constexpr int BN = 32 * WARPS;  // weight columns per block (INT8_COLS of kernels/decode_fused.py)
constexpr int SR = 64;          // weight rows per stage (INT8_STAGE_ROWS)
constexpr int NST = 6;          // ring stages
constexpr int KS = SR / 16;     // mma k-steps per stage
constexpr int XPAD = KS == 2 ? 16 : 4;  // x's row pitch pad: conflict-free 16-byte fragment loads
constexpr int MAX_SLICES = 8;   // INT8_MAX_SLICES: one portable cluster
constexpr int PITCH = BN + 16;  // bytes per staged row: rows 2t of a k-step start 8 banks apart
constexpr int MODE_STORE = 0, MODE_RESIDUAL = 1, MODE_SWIGLU = 2, MODE_ARGMAX = 3;

template <typename T>
struct Args {
  const T* x;                 // [M, K]
  const float* gamma;         // [K] f32 (rms) or null
  const int8_t* q;            // [K, ldq]
  const float* scale;         // [K / bs, ldq]
  const T* res;               // [M, N] (residual mode)
  T* out;                     // [M, N]
  unsigned long long* keys;   // [M] (argmax mode)
  int M, N, K, ldq, bs, mode, rms, vocab, kc, wfmt;
  float eps;
};

// Sum of squares of the 16 bytes at p (8 bf16 or 4 f32 values).
__device__ __forceinline__ float sumsq16(const __nv_bfloat16* p) {
  const uint4 r = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    s = fmaf(f.x, f.x, fmaf(f.y, f.y, s));
  }
  return s;
}
__device__ __forceinline__ float sumsq16(const float* p) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  return f.x * f.x + f.y * f.y + f.z * f.z + f.w * f.w;
}

__device__ __forceinline__ unsigned long long argmax_key(float v, int n) {
  unsigned int u = __float_as_uint(v);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<unsigned long long>(u) << 32) | (0xffffffffu - static_cast<unsigned int>(n));
}

__device__ __forceinline__ float silu_mul(float g, float u) { return g / (1.f + expf(-g)) * u; }

// MT: n-tiles of 8 rows of x (M <= 8 MT); VEC: bytes per weight copy (16,
// or 4 where the rows are not 16-byte aligned).
template <int MT, typename T, int VEC>
__global__ void __launch_bounds__(THREADS) qgemv8_kernel(const Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int XP = a.kc / 2 + XPAD;  // words per staged row of x
  constexpr int ROW = BN / 4;      // float4 groups per row of the tile
  unsigned char* ring = smem;                                           // [NST][SR][PITCH]
  uint32_t* xs = reinterpret_cast<uint32_t*>(smem + NST * SR * PITCH);  // [8 MT][XP]
  float4* tile = reinterpret_cast<float4*>(xs + 8 * MT * XP);           // [8 MT][ROW]
  T* resbuf = reinterpret_cast<T*>(tile + 8 * MT * ROW);                // the owner's residual
  float* gbuf = reinterpret_cast<float*>(resbuf);                        // or gamma's slice
  __shared__ float rstd[8 * MT];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const bool swiglu = a.mode == MODE_SWIGLU;
  const int tw = swiglu ? BN / 2 : BN;  // output columns per block
  const int n0 = blockIdx.x * tw, ks = blockIdx.y, nks = gridDim.y;
  const int k0 = ks * a.kc, nsteps = a.kc / SR;
  const int rows_per = 8 * MT / nks, per = rows_per * ROW;  // the tile rows this block owns
  if (nks > 1) cluster_arrive_relaxed();
  pdl_launch_dependents();

  // Staged column sc of the block -> weight column; *oc: its output column.
  auto wcol = [&](int sc, int* oc) {
    const bool up = swiglu && sc >= BN / 2;
    *oc = n0 + sc - (up ? BN / 2 : 0);
    return *oc + (up ? a.N : 0);
  };
  // This thread copies the same VEC bytes of every staged row it takes:
  // rows tid / CPR + u RSTEP of each stage.
  constexpr int CPR = BN / VEC, RSTEP = THREADS / CPR, CPT = SR / RSTEP;
  int coc;
  const int csc = VEC * (tid % CPR), ccol = wcol(csc, &coc);
  const bool copies = coc < a.N;
  const size_t rstride = (size_t)RSTEP * a.ldq, sstride = (size_t)SR * a.ldq;
  const int8_t* csrc = a.q + (size_t)(k0 + tid / CPR) * a.ldq + ccol;
  const uint32_t cdst = smem_addr(ring) + (tid / CPR) * PITCH + csc;
  auto issue = [&](int step) {
    if (!copies) return;
    const int8_t* src = csrc + step * sstride;
    const uint32_t dst = cdst + (step % NST) * (SR * PITCH);
#pragma unroll
    for (int u = 0; u < CPT; ++u) cp_async_to<VEC>(dst + u * RSTEP * PITCH, src + u * rstride);
  };
  if (a.rms)  // gamma's slice, a weight too: one group ahead of the ring's
    for (int i = tid; i < a.kc / 4; i += THREADS)
      cp_async_to<16>(smem_addr(gbuf + 4 * i), a.gamma + k0 + 4 * i);
  cp_async_commit();
#pragma unroll
  for (int s = 0; s < NST - 1; ++s) {
    if (s < nsteps) issue(s);
    cp_async_commit();
  }

  // The lane's 4 columns and the first window's scale row, in flight with
  // the ring. A window ends at the next multiple of bs (or the slice's end).
  const int sc = 32 * warp + 4 * g;
  int oc;
  const int col = wcol(sc, &oc);
  const bool live = oc < a.N;
  auto load_scale = [&](int row) {
    return live ? __ldg(reinterpret_cast<const float4*>(a.scale + (size_t)(row / a.bs) * a.ldq +
                                                       col))
                : make_float4(0.f, 0.f, 0.f, 0.f);
  };
  float4 s4 = load_scale(k0);
  int wend = min(k0 + a.kc, (k0 / a.bs + 1) * a.bs);

  // Only weights so far: x and the residual come from the kernel before.
  pdl_wait();
  if (a.mode == MODE_RESIDUAL) {  // the owner's residual groups, landing under the stream
    for (int j = tid; j < per; j += THREADS) {
      const int i = ks * per + j, m = i / ROW, n = n0 + 4 * (i % ROW);
      if (m < a.M && n < a.N)
        cp_async_to<4 * sizeof(T)>(smem_addr(resbuf + 4 * j), a.res + (size_t)m * a.N + n);
    }
  }

  if (a.rms) {  // one warp per row of x, 16-byte loads, all of a lane's in flight
    cp_async_wait<NST - 1>();  // gamma's group (visible to all after the barrier below)
    constexpr int V8 = 16 / sizeof(T);
    for (int m = warp; m < a.M; m += WARPS) {
      const T* row = a.x + (size_t)m * a.K;
      float ss = 0.f;
#pragma unroll 8
      for (int k = lane * V8; k < a.K; k += 32 * V8) ss += sumsq16(row + k);
      ss = warp_sum(ss);
      if (lane == 0) rstd[m] = rsqrtf(ss / a.K + a.eps);
    }
    __syncthreads();
  }
  // x's slice as bf16 pairs (x[m][k], x[m][k + 1]), rows of x past M zero.
  // Word w of a stage (k = 2 w) sits at slot 2 KS (w % 4) + 2 (w / 8) +
  // (w / 4) % 2, so lane t's B fragments for the stage's KS k-steps are
  // 2 KS consecutive words.
  for (int i = tid; i < 8 * MT * (a.kc / 8); i += THREADS) {
    const int m = i / (a.kc / 8), r = 8 * (i % (a.kc / 8));
    float v[8];
    if (m < a.M) {
      load8(a.x + (size_t)m * a.K + k0 + r, v);
      if (a.rms) {
        const float4 g0 = *reinterpret_cast<const float4*>(gbuf + r);
        const float4 g1 = *reinterpret_cast<const float4*>(gbuf + r + 4);
        const float gm[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = v[e] * rstd[m] * gm[e];
      }
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = 0.f;
    }
    uint32_t* xr = xs + m * XP + (r / SR) * (SR / 2) + (r % SR) / 8;
#pragma unroll
    for (int e = 0; e < 4; ++e) xr[2 * KS * e] = pack2(v[2 * e], v[2 * e + 1]);
  }

  float acc[2][MT][4], tot[2][MT][4];
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[n][mt][c] = tot[n][mt][c] = 0.f;

  const unsigned char* wl = ring + sc;
  const uint32_t* xl = xs + g * XP + 2 * KS * t;
  const F8Pair f8(a.wfmt);
  for (int s = 0; s < nsteps; ++s) {
    cp_async_wait<NST - 2>();
    __syncthreads();  // stage s landed for every thread; stage s - 1 fully read
    if (s + NST - 1 < nsteps) issue(s + NST - 1);
    cp_async_commit();

    const unsigned char* st = wl + (s % NST) * (SR * PITCH);
    uint4 bx[MT][KS / 2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < KS / 2; ++h)
        bx[mt][h] = *reinterpret_cast<const uint4*>(xl + 8 * mt * XP + s * (SR / 2) + 4 * h);
    if (a.wfmt != WFMT_INT8)
      stage_products<PITCH, KS, MT>(acc, st, bx, t, 0, KS, f8);
    else
      stage_products<PITCH, KS, MT>(acc, st, bx, t, 0, KS, S8Pair{});

    // A window ends: scale its sums by the window's row.
    if (k0 + (s + 1) * SR == wend) {
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        // c0, c1: column 4g + 2n (rows m, m + 1); c2, c3: column 4g + 2n + 1.
        const float lo = n ? s4.z : s4.x, hi = n ? s4.w : s4.y;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            tot[n][mt][c] += acc[n][mt][c] * (c < 2 ? lo : hi);
            acc[n][mt][c] = 0.f;
          }
      }
      if (s + 1 < nsteps) s4 = load_scale(wend);
      wend = min(k0 + a.kc, wend + a.bs);
    }
  }
  cp_async_wait<0>();  // this thread's residual groups

  // The lane's sums, rows m = 8 mt + 2 t + e of x, into the tile: its own
  // with one slice; else into the shared memory of the block that owns the
  // row (row m of the tile belongs to block m / rows_per of the cluster),
  // at this slice's place.
  if (nks > 1) cluster_wait();
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int m = 8 * mt + 2 * t + e;
      if (m >= a.M) continue;
      const float4 v = make_float4(tot[0][mt][e], tot[0][mt][2 + e], tot[1][mt][e],
                                   tot[1][mt][2 + e]);
      const int i = m * ROW + sc / 4;
      if (nks == 1)
        tile[i] = v;
      else
        st_cluster(tile + ks * per + i % per, i / per, v);
    }
  if (nks > 1)
    cluster_sync();
  else
    __syncthreads();

  // The owner's rows: the slices added in slice order, then the epilogue.
  // A warp's 32 groups lie in one row (ROW % 32 == 0), so the row checks
  // and the argmax's shuffles take whole warps.
  for (int j = tid; j < per; j += THREADS) {
    const int i = ks * per + j, m = i / ROW, c = 4 * (i % ROW);
    if (m >= a.M) continue;
    if (swiglu && c >= BN / 2) continue;
    float4 v = tile[j], u = make_float4(0.f, 0.f, 0.f, 0.f);
    if (swiglu) u = tile[j + BN / 8];
#pragma unroll
    for (int r = 1; r < MAX_SLICES; ++r) {
      if (r < nks) {
        const float4 p = tile[r * per + j];
        v.x += p.x; v.y += p.y; v.z += p.z; v.w += p.w;
        if (swiglu) {
          const float4 pu = tile[r * per + j + BN / 8];
          u.x += pu.x; u.y += pu.y; u.z += pu.z; u.w += pu.w;
        }
      }
    }
    const int n = n0 + c;
    if (a.mode == MODE_ARGMAX) {
      const float vv[4] = {v.x, v.y, v.z, v.w};
      unsigned long long k = 0ull;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const unsigned long long ke = n + e < a.vocab ? argmax_key(vv[e], n + e) : 0ull;
        k = ke > k ? ke : k;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const unsigned long long other = __shfl_xor_sync(0xffffffffu, k, o);
        k = other > k ? other : k;
      }
      if (lane == 0 && k) atomicMax(a.keys + m, k);
      continue;
    }
    if (n >= a.N) continue;
    if (a.mode == MODE_RESIDUAL) {
      const float4 r = load4(resbuf + 4 * j);
      v.x += r.x; v.y += r.y; v.z += r.z; v.w += r.w;
    } else if (swiglu) {
      v = make_float4(silu_mul(v.x, u.x), silu_mul(v.y, u.y), silu_mul(v.z, u.z),
                      silu_mul(v.w, u.w));
    }
    store4(a.out + (size_t)m * a.N + n, v);
  }
}

// Row keys -> column indices (the low 32 bits hold the inverted index).
__global__ void argmax_index(const unsigned long long* __restrict__ keys, int* __restrict__ out,
                             int M) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m < M) out[m] = static_cast<int>(0xffffffffu - static_cast<unsigned int>(keys[m]));
}

template <int MT, typename T, int VEC>
int launch(const Args<T>& a, int ksplit, cudaStream_t stream) {
  const int rows_per = 8 * MT / ksplit;
  const int smem = NST * SR * PITCH + 8 * MT * (a.kc / 2 + XPAD) * 4 + 8 * MT * BN * 4 +
                   (a.mode == MODE_RESIDUAL ? rows_per * BN * (int)sizeof(T) : 0) +
                   (a.rms ? a.kc * 4 : 0);
  auto kern = qgemv8_kernel<MT, T, VEC>;
  static int allowed = 48 * 1024;
  if (smem > allowed) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    allowed = smem;
  }
  const int tw = a.mode == MODE_SWIGLU ? BN / 2 : BN;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((a.N + tw - 1) / tw, ksplit);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attrs[2];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = 1;
  attrs[0].val.clusterDim.y = ksplit;
  attrs[0].val.clusterDim.z = 1;
  // The weight stream of this launch may start under the tail of the kernel
  // before it (the kernel waits for it before it reads x or the residual).
  attrs[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attrs[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attrs;
  cfg.numAttrs = 2;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, kern, a));
}

template <typename T>
int run(const void* x, const void* gamma, const void* q, const void* scale, const void* res,
        void* out, unsigned long long* keys, int vocab, int M, int N, int K, int ldq, int bs,
        int mode, int rms, float eps, int ksplit, int m_tile, int wfmt, cudaStream_t st) {
  const bool vec16 = reinterpret_cast<uintptr_t>(q) % 16 == 0 && ldq % 16 == 0 && N % 16 == 0;
  const Args<T> a{static_cast<const T*>(x), static_cast<const float*>(gamma),
                  static_cast<const int8_t*>(q), static_cast<const float*>(scale),
                  static_cast<const T*>(res), static_cast<T*>(out), keys, M, N, K, ldq, bs, mode,
                  rms, vocab, K / ksplit, wfmt, eps};
#define QGEMV8_LAUNCH(MT) \
  return vec16 ? launch<MT, T, 16>(a, ksplit, st) : launch<MT, T, 4>(a, ksplit, st)
  if (m_tile <= 8) QGEMV8_LAUNCH(1);
  if (m_tile <= 16) QGEMV8_LAUNCH(2);
  QGEMV8_LAUNCH(4);
#undef QGEMV8_LAUNCH
}

}  // namespace

// x [M, K]; gamma [K] f32 or null (rms = 0); q [K, ldq] one-byte weights
// in format wfmt (0 int8, 1 fp8 e4m3fn, 2 fp8 e5m2); scale [K / block_size,
// ldq] f32, the QTensor's own (no fp8 fixup); res [M, N] or null; out
// [M, N]. N is the output width: ldq for store/residual, ldq / 2 for SwiGLU (gate columns
// [0, N), up columns [N, 2N)). mode: 0 store, 1 +residual, 2 SwiGLU.
// ksplit (1, 2, 4 or 8: one cluster) slices of kc = K / ksplit rows (kc %
// 64 == 0); block_size % 64 == 0 or block_size == K. m_tile 8, 16 or 32 (M
// <= m_tile). Needs N % 4 == 0, 16-byte aligned x, gamma, res, out and
// scale, and x's staged slice of 8 ceil(M / 8) (kc / 2 + 4) 4-byte pairs
// in shared memory beside the 102 KB ring, the 8-32 KB tile and gamma's
// slice or the residual (kernels/decode_fused.py:plan_qgemv). x, res and
// out are f32 when is_f32, else bf16 (checked by the Python wrapper).
// Returns the launch's cudaError_t.
extern "C" int qgemv_int8(const void* x, const void* gamma, const void* q, const void* scale,
                          const void* res, void* out, int M, int N, int K, int ldq,
                          int block_size, int mode, int rms, float eps, int ksplit, int m_tile,
                          int is_f32, int wfmt, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_f32)
    return run<float>(x, gamma, q, scale, res, out, nullptr, 0, M, N, K, ldq, block_size, mode,
                      rms, eps, ksplit, m_tile, wfmt, s);
  return run<__nv_bfloat16>(x, gamma, q, scale, res, out, nullptr, 0, M, N, K, ldq, block_size,
                            mode, rms, eps, ksplit, m_tile, wfmt, s);
}

// Greedy head: out[m] = argmax over n < vocab of rmsnorm(x)[m] @ dequant(q)[:, n]
// (first index on ties), with the same arithmetic as qgemv_int8's store mode.
// keys [M] u64 scratch (cleared here); out [M] int32; the rest as qgemv_int8.
extern "C" int qgemv_int8_argmax(const void* x, const void* gamma, const void* q,
                                 const void* scale, void* keys, void* out, int M, int N, int K,
                                 int block_size, int vocab, float eps, int ksplit, int m_tile,
                                 int is_f32, int wfmt, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned long long* k = static_cast<unsigned long long*>(keys);
  cudaMemsetAsync(k, 0, sizeof(unsigned long long) * M, s);
  const int rc =
      is_f32 ? run<float>(x, gamma, q, scale, nullptr, nullptr, k, vocab, M, N, K, N, block_size,
                          MODE_ARGMAX, 1, eps, ksplit, m_tile, wfmt, s)
             : run<__nv_bfloat16>(x, gamma, q, scale, nullptr, nullptr, k, vocab, M, N, K, N,
                                  block_size, MODE_ARGMAX, 1, eps, ksplit, m_tile, wfmt, s);
  if (rc) return rc;
  argmax_index<<<1, 32, 0, s>>>(k, static_cast<int*>(out), M);
  return static_cast<int>(cudaGetLastError());
}
