// CTC prefix scoring of beam candidates (ESPnet's CTCPrefixScore, one
// beam step of the hybrid CTC/attention search).
//
// No TPU kernel is replaced: the JAX package has no CTC head. The plain
// version and the semantics are in kernels/ctc_prefix.py. For candidate c
// of hypothesis g (length n, state rn_t(g), rb_t(g), last token l) over the
// utterance's valid frames t < Tb, with s = max(n, 1):
//   phi_t      = rn_t(g) (+) rb_t(g), or rb_t(g) when c == l
//   rn_t(g.c)  = (rn_{t-1}(g.c) (+) phi_{t-1}) + x_t(c)          t in [s, Tb)
//   rb_t(g.c)  = (rn_{t-1}(g.c) (+) rb_{t-1}(g.c)) + x_t(blank)   t in [s, Tb)
//   psi        = rn_{s-1}(g.c) (+) sum_t (+) (phi_{t-1} + x_t(c))
// where (+) is log-add-exp, rn_{s-1}(g.c) = x_0(c) if n == 0 else log 0;
// psi of <eos> is rn_{Tb-1}(g) (+) rb_{Tb-1}(g), psi of blank log 0. Every
// state entry outside [s, Tb) is log 0 (-1e10), but rn_0 = x_0(c) at n 0.
//
// Design. The recursion runs along time, ~750 frames at the longest
// buckets, for a few hundred candidates: one thread a candidate would
// chain 750 dependent log-add-exps. But each recursion is a first-order
// linear one in the log semiring: y_t = (y_{t-1} (+) u_t) + e_t is the map
// y -> (A + y) (+) B with (A, B) = (e_t, u_t + e_t), and two such maps
// compose to (A1 + A2, (A2 + B1) (+) B2). So one warp takes a candidate:
// lane l owns a contiguous chunk of the frames, composes its chunk's maps,
// a warp scan (5 shuffle rounds) gives each lane the map of all earlier
// chunks, and each lane then runs its chunk from the value that enters it.
// rn first (psi is a warp reduction of the same terms), then rb, whose map
// needs rn_{t-1}. The x_t(c) rows are contiguous because the log-probs are
// held [B, V, T]; the parent's state [R, 2, T] and x_t(blank) are shared
// by the candidates of a row and of an utterance and come from cache.
//
// What bounds it on an H100: bytes (each candidate reads its row of x and
// the parent's state and writes its own state: ~5 MB a step at 80 rows,
// P 7, T 749; ~20 f32 operations a candidate-frame). It is latency-bound
// above that: three dependent passes over ~24 frames a lane and two scans.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kLogZero = -1.0e10f;
constexpr int kWarps = 4;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float lae(float a, float b) {
  const float m = fmaxf(a, b);
  return m + log1pf(expf(-fabsf(a - b)));
}

// Inclusive scan of the maps (A, B) over the warp's lanes, in lane order;
// returns the exclusive prefix (identity (0, log 0) at lane 0).
__device__ __forceinline__ void scan_maps(float& a, float& b, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float pa = __shfl_up_sync(kFull, a, d);
    const float pb = __shfl_up_sync(kFull, b, d);
    if (lane >= d) {
      b = lae(a + pb, b);
      a = pa + a;
    }
  }
  const float ea = __shfl_up_sync(kFull, a, 1);
  const float eb = __shfl_up_sync(kFull, b, 1);
  a = lane ? ea : 0.f;
  b = lane ? eb : kLogZero;
}

__global__ void __launch_bounds__(kWarps * 32)
ctc_prefix_kernel(const float* __restrict__ logp, const float* __restrict__ state,
                  const int* __restrict__ last, const int* __restrict__ cand,
                  const int* __restrict__ lens, float* __restrict__ psi,
                  float* __restrict__ out, int R, int P, int beams, int V, int T,
                  const int* __restrict__ n_dev, int blank, int eos) {
  const int w = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (w >= R * P) return;   // whole warps only
  const int row = w / P;
  const int b = row / beams;
  const int c = cand[w];
  const int n = *n_dev;
  const int tb = min(lens[b], T);
  const int s = max(n, 1);
  const float* xc = logp + (static_cast<size_t>(b) * V + c) * T;
  const float* xb = logp + (static_cast<size_t>(b) * V + blank) * T;
  const float* rn_g = state + static_cast<size_t>(row) * 2 * T;
  const float* rb_g = rn_g + T;
  float* rn = out + static_cast<size_t>(w) * 2 * T;
  float* rb = rn + T;
  const bool same = c == last[row];
  const float init = n == 0 ? xc[0] : kLogZero;   // rn_{s-1}(g.c)

  // Frames [s, tb), in contiguous chunks a lane.
  const int len = max(tb - s, 0);
  const int chunk = (len + 31) >> 5;
  const int t0 = s + lane * chunk;
  const int t1 = min(t0 + chunk, tb);

  // Pass 1: the chunk's rn maps and psi terms.
  float a = 0.f, bb = kLogZero, ps = kLogZero;
  for (int t = t0; t < t1; ++t) {
    const float phi = same ? rb_g[t - 1] : lae(rn_g[t - 1], rb_g[t - 1]);
    const float e = xc[t];
    const float term = phi + e;
    bb = lae(e + bb, term);
    a += e;
    ps = lae(ps, term);
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) ps = lae(ps, __shfl_xor_sync(kFull, ps, o));
  scan_maps(a, bb, lane);
  const float y_in = lae(a + init, bb);   // rn_{t0-1}(g.c)

  // Pass 2: rn over the chunk, and the chunk's rb maps (they read rn_{t-1}).
  float y = y_in, ab = 0.f, bbb = kLogZero;
  for (int t = t0; t < t1; ++t) {
    const float x0 = xb[t];
    bbb = lae(x0 + bbb, y + x0);
    ab += x0;
    const float phi = same ? rb_g[t - 1] : lae(rn_g[t - 1], rb_g[t - 1]);
    y = lae(y, phi) + xc[t];
    rn[t] = y;
  }
  scan_maps(ab, bbb, lane);
  float z = lae(ab + kLogZero, bbb);      // rb_{t0-1}(g.c)

  // Pass 3: rb over the chunk.
  for (int t = t0; t < t1; ++t) {
    const float prev = t == t0 ? y_in : rn[t - 1];
    z = lae(z, prev) + xb[t];
    rb[t] = z;
  }

  // log 0 outside [s, tb), but rn_0 = x_0(c) at n == 0.
  for (int t = lane; t < T; t += 32) {
    if (t < s || t >= tb) {
      rn[t] = t == 0 && n == 0 ? init : kLogZero;
      rb[t] = kLogZero;
    }
  }
  if (lane == 0) {
    float v = lae(init, ps);
    if (c == eos) v = tb > 0 ? lae(rn_g[tb - 1], rb_g[tb - 1]) : kLogZero;
    if (c == blank) v = kLogZero;
    psi[w] = v;
  }
}

}  // namespace

// logp [B, V, T], state [R, 2, T] (R = B * beams), last [R], cand [R, P],
// lens [B] -> psi [R, P], out [R, P, 2, T]. n_dev holds n, every
// hypothesis's length (the decode step's index), in device memory.
extern "C" int st_ctc_prefix(const float* logp, const float* state, const int* last,
                             const int* cand, const int* lens, float* psi, float* out,
                             int R, int P, int beams, int V, int T, const int* n_dev,
                             int blank, int eos, cudaStream_t stream) {
  if (R < 1 || P < 1 || beams < 1 || T < 1 || !n_dev) return cudaErrorInvalidValue;
  const int blocks = (R * P + kWarps - 1) / kWarps;
  ctc_prefix_kernel<<<blocks, kWarps * 32, 0, stream>>>(logp, state, last, cand, lens, psi,
                                                         out, R, P, beams, V, T, n_dev,
                                                         blank, eos);
  return cudaGetLastError();
}
