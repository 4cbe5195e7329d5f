// Native real-time ITD tier: the port's own copy of the JAX package's
// native library (pyitd_tpu/native/itd_native.cpp), the same code built
// with the same flags, so the two libraries agree bit for bit on one
// machine.
//
// Clean-room C++ equivalent of the reference implementation's native layer
// (its itd.cpp and modpool.c): block/streaming baseline extraction for
// scalar and IQ data with extrema reuse, plus a thread-pool batch runner
// with a throughput harness.  The card path (PyTorch/CUDA) covers large
// batched offline work; this library covers the real-time audio/SDR use
// case (hop-sized latency, no Python in the loop) and host-side parallel
// batches.
//
// Differences from the reference, on purpose:
//  * double precision, caller-provided buffers, no globals/static state —
//    reentrant and thread-safe;
//  * mathematically exact Thomas elimination for the natural cubic spline
//    (the reference's recurrence skips the superdiagonal normalization);
//  * defined behavior at the edges (the reference reads past its arrays).
//
// Build: pyitd_tpu_torch/ops/_build.py::build_host, at first use, with the
// host C++ compiler and the JAX package's Makefile flags
// (-O3 -march=native -fPIC -std=c++17 -Wall -shared ... -lpthread).

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// core kernels
// ---------------------------------------------------------------------------

// Interior extrema, plateau-rightmost rule (both minima and maxima).
int detect_extrema(const double* x, int n, int* out) {
  int m = 0;
  for (int i = 1; i < n - 1; ++i) {
    const double db = x[i] - x[i - 1];
    const double df = x[i + 1] - x[i];
    if ((db <= 0.0 && df > 0.0) || (db >= 0.0 && df < 0.0)) out[m++] = i;
  }
  return m;
}

// Joint IQ extrema: simultaneous extremum in both channels.
int detect_extrema_iq(const double* re, const double* im, int n, int* out) {
  int m = 0;
  for (int i = 1; i < n - 1; ++i) {
    const bool re_ext = (re[i - 1] < re[i] && re[i] >= re[i + 1]) ||
                        (re[i - 1] > re[i] && re[i] <= re[i + 1]);
    const bool im_ext = (im[i - 1] < im[i] && im[i] >= im[i + 1]) ||
                        (im[i - 1] > im[i] && im[i] <= im[i + 1]);
    if (re_ext && im_ext) out[m++] = i;
  }
  return m;
}

// Frei-Osorio knot values over given extrema positions; ends pinned to the
// signal value at the first/last knot.
void knot_values(const double* x, const int* e, int m, double* k) {
  const double alpha = 0.5;
  k[0] = x[e[0]];
  k[m - 1] = x[e[m - 1]];
  for (int j = 1; j < m - 1; ++j) {
    const double w =
        double(e[j] - e[j - 1]) / double(e[j + 1] - e[j - 1]);
    k[j] = alpha * (x[e[j - 1]] + w * (x[e[j + 1]] - x[e[j - 1]])) +
           (1.0 - alpha) * x[e[j]];
  }
}

// Natural cubic spline through (e[j], k[j]), evaluated on [lo, hi) into
// baseline[lo..hi).  Exact Thomas elimination; scratch sized >= m.
void spline_eval(const int* e, const double* k, int m, int lo, int hi,
                 double* baseline, double* h, double* cp, double* dp,
                 double* mom) {
  if (m < 2) {
    for (int i = lo; i < hi; ++i) baseline[i] = 0.0;
    return;
  }
  for (int j = 0; j < m - 1; ++j) h[j] = double(e[j + 1] - e[j]);

  // moment system: lower=h[j-1], diag=2(h[j-1]+h[j]), upper=h[j],
  // rhs = 6*(dd_j - dd_{j-1}); natural ends mom[0] = mom[m-1] = 0.
  mom[0] = 0.0;
  mom[m - 1] = 0.0;
  if (m > 2) {
    // forward sweep over interior rows 1..m-2
    double prev_cp = 0.0, prev_dp = 0.0;
    for (int j = 1; j <= m - 2; ++j) {
      const double lower = (j == 1) ? 0.0 : h[j - 1];
      const double diag = 2.0 * (h[j - 1] + h[j]);
      const double upper = (j == m - 2) ? 0.0 : h[j];
      const double rhs = 6.0 * ((k[j + 1] - k[j]) / h[j] -
                                (k[j] - k[j - 1]) / h[j - 1]);
      const double denom = diag - lower * prev_cp;
      prev_cp = upper / denom;
      prev_dp = (rhs - lower * prev_dp) / denom;
      cp[j] = prev_cp;
      dp[j] = prev_dp;
    }
    mom[m - 2] = dp[m - 2];
    for (int j = m - 3; j >= 1; --j) mom[j] = dp[j] - cp[j] * mom[j + 1];
  }

  int j = 0;
  for (int i = lo; i < hi; ++i) {
    while (j < m - 2 && e[j + 1] <= i) ++j;
    const double hj = h[j];
    const double t = double(i - e[j]) / hj;
    const double omt = 1.0 - t;
    baseline[i] = omt * k[j] + t * k[j + 1] +
                  hj * hj / 6.0 *
                      ((omt * omt * omt - omt) * mom[j] +
                       (t * t * t - t) * mom[j + 1]);
  }
}

struct Scratch {
  std::vector<int> extrema;
  std::vector<double> knots, h, cp, dp, mom;
  void resize(int n) {
    extrema.resize(size_t(n) + 2);
    knots.resize(size_t(n) + 2);
    h.resize(size_t(n) + 2);
    cp.resize(size_t(n) + 2);
    dp.resize(size_t(n) + 2);
    mom.resize(size_t(n) + 2);
  }
};

void baseline_full(const double* x, double* baseline, int n, int* extrema,
                   int* count, bool compute_extrema, Scratch& s) {
  if (compute_extrema) *count = detect_extrema(x, n, extrema);
  const int m = *count;
  if (m < 2) {
    std::memset(baseline, 0, sizeof(double) * size_t(n));
    return;
  }
  s.resize(n);
  knot_values(x, extrema, m, s.knots.data());
  spline_eval(extrema, s.knots.data(), m, 0, n, baseline, s.h.data(),
              s.cp.data(), s.dp.data(), s.mom.data());
  // outside the knot span: clamp to the end knots (defined edge behavior)
  for (int i = 0; i < extrema[0]; ++i) baseline[i] = s.knots[0];
  for (int i = extrema[m - 1] + 1; i < n; ++i) baseline[i] = s.knots[m - 1];
}

}  // namespace

extern "C" {

// One-shot baseline extraction with extrema reuse.  `extrema`/`count` are
// caller-owned (capacity >= n); with compute_extrema=false the cached
// positions are reused to process adjusted data or other channels
// (the reference's multi-channel reuse protocol, itd.cpp:41-44).
void pyitd_baseline_extract(const double* data, double* baseline, int n,
                            int* extrema, int* count, int compute_extrema) {
  thread_local Scratch s;
  baseline_full(data, baseline, n, extrema, count, compute_extrema != 0, s);
}

// IQ variant: joint extrema, averaged-channel knot values.
void pyitd_baseline_extract_iq(const double* re, const double* im,
                               double* baseline, int n, int* extrema,
                               int* count, int compute_extrema) {
  thread_local Scratch s;
  thread_local std::vector<double> avg;
  if (compute_extrema) *count = detect_extrema_iq(re, im, n, extrema);
  const int m = *count;
  if (m < 2) {
    std::memset(baseline, 0, sizeof(double) * size_t(n));
    return;
  }
  avg.resize(size_t(n));
  for (int i = 0; i < n; ++i) avg[i] = 0.5 * (re[i] + im[i]);
  s.resize(n);
  knot_values(avg.data(), extrema, m, s.knots.data());
  spline_eval(extrema, s.knots.data(), m, 0, n, baseline, s.h.data(),
              s.cp.data(), s.dp.data(), s.mom.data());
  for (int i = 0; i < extrema[0]; ++i) baseline[i] = s.knots[0];
  for (int i = extrema[m - 1] + 1; i < n; ++i) baseline[i] = s.knots[m - 1];
}

// ---------------------------------------------------------------------------
// streaming processor: circular 3-hop buffer, recompute the inner third
// (the protocol prescribed at itd.cpp:31-39)
// ---------------------------------------------------------------------------

struct pyitd_stream {
  int hop = 0;
  int filled = 0;  // number of hops buffered (0..3)
  std::vector<double> buf;  // 3*hop circular-by-copy
  Scratch scratch;
};

pyitd_stream* pyitd_stream_new(int hop) {
  auto* s = new pyitd_stream;
  s->hop = hop;
  s->buf.assign(size_t(hop) * 3, 0.0);
  return s;
}

void pyitd_stream_free(pyitd_stream* s) { delete s; }

// Push one hop of samples.  Returns 1 and writes `out_baseline` /
// `out_rotation` (hop samples = the buffer's inner third) once 3 hops are
// buffered; returns 0 while priming.
int pyitd_stream_push(pyitd_stream* s, const double* hop_samples,
                      double* out_rotation, double* out_baseline) {
  const int hop = s->hop;
  const int n = 3 * hop;
  std::memmove(s->buf.data(), s->buf.data() + hop,
               sizeof(double) * size_t(2 * hop));
  std::memcpy(s->buf.data() + 2 * hop, hop_samples,
              sizeof(double) * size_t(hop));
  if (s->filled < 3) {
    ++s->filled;
    if (s->filled < 3) return 0;
  }

  s->scratch.resize(n);
  int* e = s->scratch.extrema.data();
  int m = detect_extrema(s->buf.data(), n, e);
  if (m < 2) {
    for (int i = 0; i < hop; ++i) {
      out_baseline[i] = 0.0;
      out_rotation[i] = s->buf[hop + i];
    }
    return 1;
  }
  // window: last extremum in the first third .. first extremum in the last
  // third; fall back to the overall ends when a third has no extremum.
  int lo_idx = 0, hi_idx = m - 1;
  for (int j = 0; j < m; ++j) {
    if (e[j] < hop) lo_idx = j;
    if (e[j] >= 2 * hop) { hi_idx = j; break; }
  }
  const int mm = hi_idx - lo_idx + 1;
  if (mm < 2) {
    for (int i = 0; i < hop; ++i) {
      out_baseline[i] = 0.0;
      out_rotation[i] = s->buf[hop + i];
    }
    return 1;
  }
  std::vector<double>& knots = s->scratch.knots;
  knot_values(s->buf.data(), e + lo_idx, mm, knots.data());
  std::vector<double> inner(size_t(n), 0.0);
  spline_eval(e + lo_idx, knots.data(), mm, hop, 2 * hop, inner.data(),
              s->scratch.h.data(), s->scratch.cp.data(),
              s->scratch.dp.data(), s->scratch.mom.data());
  for (int i = 0; i < hop; ++i) {
    const double b = inner[hop + i];
    out_baseline[i] = b;
    out_rotation[i] = s->buf[hop + i] - b;
  }
  return 1;
}

// ---------------------------------------------------------------------------
// thread pool batch runner (the modpool.c capability: run many independent
// decompositions concurrently + a tasks/sec harness)
// ---------------------------------------------------------------------------

struct pyitd_pool {
  std::vector<std::thread> workers;
  std::mutex mu;
  std::condition_variable cv_work, cv_done;
  std::atomic<int> next{0};
  int total = 0;
  std::atomic<int> finished{0};
  int active = 0;  // workers inside a batch's claim loop (guarded by mu)
  bool stop = false;
  uint64_t generation = 0;
  // current batch
  const double* signals = nullptr;
  double* baselines = nullptr;
  double* rotations = nullptr;
  int siglen = 0;
  int spin_us = 0;  // bench mode: busy-wait task instead of real work

  explicit pyitd_pool(int nthreads) {
    if (nthreads < 1) nthreads = 1;
    for (int t = 0; t < nthreads; ++t)
      workers.emplace_back([this] { this->worker(); });
  }

  ~pyitd_pool() {
    {
      std::lock_guard<std::mutex> l(mu);
      stop = true;
    }
    cv_work.notify_all();
    for (auto& w : workers) w.join();
  }

  void worker() {
    Scratch scratch;
    uint64_t seen = 0;
    for (;;) {
      int my_total;
      {
        std::unique_lock<std::mutex> l(mu);
        cv_work.wait(l, [&] { return stop || generation != seen; });
        if (stop) return;
        seen = generation;
        ++active;
        my_total = total;  // batch snapshot: no unlocked reads of total
      }
      for (;;) {
        const int i = next.fetch_add(1);
        if (i >= my_total) break;
        if (spin_us > 0) {
          const auto end = std::chrono::steady_clock::now() +
                           std::chrono::microseconds(spin_us);
          while (std::chrono::steady_clock::now() < end) {}
        } else {
          const double* x = signals + size_t(i) * size_t(siglen);
          double* b = baselines + size_t(i) * size_t(siglen);
          int count = 0;
          scratch.resize(siglen);
          baseline_full(x, b, siglen, scratch.extrema.data(), &count, true,
                        scratch);
          if (rotations) {
            double* r = rotations + size_t(i) * size_t(siglen);
            for (int k = 0; k < siglen; ++k) r[k] = x[k] - b[k];
          }
        }
        if (finished.fetch_add(1) + 1 == my_total) cv_done.notify_all();
      }
      {
        std::lock_guard<std::mutex> l(mu);
        --active;
      }
      cv_done.notify_all();  // a run() may be waiting for the pool to park
    }
  }

  void run(int ntasks) {
    std::unique_lock<std::mutex> l(mu);
    // Park barrier: a straggler suspended between next.fetch_add and its
    // bounds check must never observe a reset counter/total from the
    // NEXT batch (it would execute an unclaimed task and double-count
    // `finished`, letting run() return with a task still in flight).
    // Resetting only once every worker has left the previous batch's
    // claim loop makes stale claims impossible.
    cv_done.wait(l, [&] { return active == 0; });
    next.store(0);
    finished.store(0);
    total = ntasks;
    ++generation;
    l.unlock();
    cv_work.notify_all();
    l.lock();
    cv_done.wait(l, [&] { return finished.load() >= ntasks; });
  }
};

pyitd_pool* pyitd_pool_new(int nthreads) { return new pyitd_pool(nthreads); }
void pyitd_pool_free(pyitd_pool* p) { delete p; }

// Parallel batch baseline extraction: signals (batch, n) row-major.
void pyitd_pool_extract_batch(pyitd_pool* p, const double* signals,
                              double* rotations, double* baselines,
                              int batch, int n) {
  p->signals = signals;
  p->baselines = baselines;
  p->rotations = rotations;
  p->siglen = n;
  p->spin_us = 0;
  p->run(batch);
}

// Throughput harness (modpool.c:155-190 equivalent): run `ntasks` dummy
// tasks of `task_us` microseconds each; returns tasks/sec.
double pyitd_pool_bench(pyitd_pool* p, int ntasks, int task_us) {
  p->spin_us = task_us;
  const auto t0 = std::chrono::steady_clock::now();
  p->run(ntasks);
  const auto t1 = std::chrono::steady_clock::now();
  p->spin_us = 0;
  const double sec =
      std::chrono::duration_cast<std::chrono::duration<double>>(t1 - t0)
          .count();
  return ntasks / sec;
}

}  // extern "C"
