// Native single-chain WALNUTS engine.
//
// Fills the reference's "performant native implementation" slot: the
// reference repo only forwards to an external C++ engine
// (walnuts_cpp/README.md:1 -> flatironinstitute/walnuts), so this is a
// from-scratch C++17 implementation of the WALNUTS transition
// (biased-progressive doubling, sub-U-turn plans, online multinomial
// selection, R2P / deterministic / fixed-leapfrog integrators) matching
// the semantics of the Python research sampler
// (WALNUTSpy/WALNUTS.py:111-727, adaptiveIntegrators.py:361-475).
//
// Used from Python via ctypes (walnuts_tpu/native/__init__.py) as
//   * the single-core native baseline in bench.py, and
//   * a fast CPU oracle for statistical cross-checks of the JAX engines.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC -o libwalnuts_native.so \
//            walnuts_engine.cpp

#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <random>
#include <vector>

namespace {

constexpr double kLogZero = -700.0;

using Vec = std::vector<double>;

// ----------------------------------------------------------------- targets
struct Target {
  int id;   // 0 = std_gauss, 1 = funnel, 2 = corr_gauss(rho=0.5)
  int dim;

  // logp and gradient in one pass; returns logp, writes grad.
  double logp_grad(const double* q, double* g) const {
    switch (id) {
      case 0: {  // iid standard normal
        double lp = 0.0;
        for (int i = 0; i < dim; ++i) {
          lp -= 0.5 * q[i] * q[i];
          g[i] = -q[i];
        }
        return lp;
      }
      case 1: {  // Neal funnel: w ~ N(0,9), x_i|w ~ N(0, e^w)
        const double w = q[0];
        const double e = std::exp(-w);
        double ss = 0.0;
        for (int i = 1; i < dim; ++i) ss += q[i] * q[i];
        const int k = dim - 1;
        double lp = -0.5 * (w / 3.0) * (w / 3.0) - 0.5 * e * ss
                    - 0.5 * k * w;
        g[0] = -w / 9.0 + 0.5 * e * ss - 0.5 * k;
        for (int i = 1; i < dim; ++i) g[i] = -q[i] * e;
        return lp;
      }
      default: {  // bivariate correlated normal, rho = 0.5
        const double rho = 0.5, tmp = 1.0 - rho * rho;
        const double q0 = q[0], q1 = q[1];
        double lp = -0.5 * q0 * q0 - 0.5 / tmp * (q1 - rho * q0)
                                      * (q1 - rho * q0);
        g[0] = -(q0 - rho * q1) / tmp;
        g[1] = -(q1 - rho * q0) / tmp;
        return lp;
      }
    }
  }
};

struct State {
  Vec q, v, g;
  double lp = 0.0, ham = 0.0;
};

double kinetic(const Vec& v) {
  double k = 0.0;
  for (double x : v) k += x * x;
  return 0.5 * k;
}

// n leapfrog steps of size h; returns #grad evals, tracks max |dH|.
int leapfrog(const Target& t, State& s, double h, int n, double* max_dh) {
  double ham_prev = -s.lp + kinetic(s.v);
  const int d = t.dim;
  for (int k = 0; k < n; ++k) {
    for (int i = 0; i < d; ++i) s.v[i] += 0.5 * h * s.g[i];
    for (int i = 0; i < d; ++i) s.q[i] += h * s.v[i];
    s.lp = t.logp_grad(s.q.data(), s.g.data());
    for (int i = 0; i < d; ++i) s.v[i] += 0.5 * h * s.g[i];
    const double ham = -s.lp + kinetic(s.v);
    const double dh = std::fabs(ham - ham_prev);
    if (dh > *max_dh) *max_dh = dh;
    ham_prev = ham;
  }
  s.ham = ham_prev;
  return n;
}

struct IgrResult {
  State s;
  int n_eval = 0;
  int i_f = 0, i_b = 0, c_sim = 0;
  double lwt = 0.0;
  bool finite = true;
};

// Randomized two-point integrator (adaptiveIntegrators.py:361-475).
IgrResult r2p_step(const Target& t, const State& in, double h_macro,
                   double delta, int min_c, int max_c, std::mt19937_64& rng) {
  std::uniform_real_distribution<double> unif(0.0, 1.0);
  IgrResult out;
  // forward halving search
  int i_f = max_c;
  State best;
  for (int c = min_c; c <= max_c; ++c) {
    State trial = in;
    double max_dh = 0.0;
    const int n = 1 << c;
    out.n_eval += leapfrog(t, trial, h_macro / n, n, &max_dh);
    const double err = std::fabs(trial.ham - (-in.lp + kinetic(in.v)));
    if (std::isfinite(trial.ham) && err < delta) {
      i_f = c;
      best = trial;
      break;
    }
    if (c == max_c) best = trial;
  }
  // two-point randomization
  const bool coarse = unif(rng) < 2.0 / 3.0;
  int c_sim = i_f;
  if (!coarse) {
    c_sim = i_f + 1;
    State trial = in;
    double max_dh = 0.0;
    const int n = 1 << c_sim;
    out.n_eval += leapfrog(t, trial, h_macro / n, n, &max_dh);
    best = trial;
  }
  // backward pass
  State back0 = best;
  for (double& x : back0.v) x = -x;
  const double ham_b0 = -back0.lp + kinetic(back0.v);
  int i_b = coarse ? i_f : max_c;
  const int max_try = coarse ? i_f - 1 : max_c;
  for (int c = min_c; c <= max_try; ++c) {
    State trial = back0;
    double max_dh = 0.0;
    const int n = 1 << c;
    out.n_eval += leapfrog(t, trial, h_macro / n, n, &max_dh);
    if (std::isfinite(trial.ham) &&
        std::fabs(trial.ham - ham_b0) < delta) {
      i_b = c;
      break;
    }
  }
  const double lp0 = std::log(2.0 / 3.0), lp1 = std::log(1.0 / 3.0);
  const double fwd_term = coarse ? lp0 : lp1;
  double bwd_term;
  if (c_sim == i_b) bwd_term = lp0;
  else if (c_sim == i_b + 1) bwd_term = lp1;
  else bwd_term = kLogZero;
  out.s = best;
  out.i_f = i_f;
  out.i_b = i_b;
  out.c_sim = c_sim;
  out.lwt = bwd_term - fwd_term;
  out.finite = std::isfinite(best.ham);
  return out;
}

// fixed single leapfrog (multinomial NUTS mode)
IgrResult fixed_step(const Target& t, const State& in, double h_macro) {
  IgrResult out;
  State trial = in;
  double max_dh = 0.0;
  out.n_eval = leapfrog(t, trial, h_macro, 1, &max_dh);
  out.s = trial;
  out.finite = std::isfinite(trial.ham);
  return out;
}

bool uturn(const Vec& qm, const Vec& vm, const Vec& qp, const Vec& vp) {
  double a = 0.0, b = 0.0;
  for (size_t i = 0; i < qm.size(); ++i) {
    const double diff = qp[i] - qm[i];
    a += vp[i] * diff;
    b += vm[i] * diff;
  }
  return a < 0.0 || b < 0.0;
}

// One WALNUTS transition; whole-orbit storage (oracle mode; the
// memory-frugal id-slab trick lives in the JAX engines).
struct Sampler {
  Target target;
  double h0, delta;
  int m, min_c, max_c;
  bool adaptive;  // false = fixed leapfrog
  std::mt19937_64 rng;
  long long n_grad = 0;

  // per-transition diagnostics (reference diag cols 8/9, orbit
  // min/max of the first generated coordinate, col 17 energy error,
  // and the per-iteration gradient count) — reset in transition()
  int it_min_if = 0, it_max_if = 0;
  double it_q0_min = 0.0, it_q0_max = 0.0;
  double it_ham_min = 0.0, it_ham_max = 0.0;
  long long it_grads = 0;

  State make_state(const double* q) {
    State s;
    s.q.assign(q, q + target.dim);
    s.v.assign(target.dim, 0.0);
    s.g.assign(target.dim, 0.0);
    s.lp = target.logp_grad(s.q.data(), s.g.data());
    return s;
  }

  void track_state(const State& s) {
    if (s.q[0] < it_q0_min) it_q0_min = s.q[0];
    if (s.q[0] > it_q0_max) it_q0_max = s.q[0];
    if (std::isfinite(s.ham)) {
      if (s.ham < it_ham_min) it_ham_min = s.ham;
      if (s.ham > it_ham_max) it_ham_max = s.ham;
    }
  }

  void transition(State& cur) {
    std::normal_distribution<double> norm(0.0, 1.0);
    std::uniform_real_distribution<double> unif(0.0, 1.0);
    for (int i = 0; i < target.dim; ++i) cur.v[i] = norm(rng);
    cur.ham = -cur.lp + kinetic(cur.v);

    it_min_if = max_c + 1;
    it_max_if = -1;
    it_q0_min = it_q0_max = cur.q[0];
    it_ham_min = it_ham_max = cur.ham;
    const long long grad0 = n_grad;

    // orbit segments: states + weights, with plus/minus ends
    State sp = cur, sm = cur;
    double lwt_sum_f = 0.0, lwt_sum_b = 0.0;
    const double mscale = cur.ham;
    double w_old_sum = 1.0;  // exp(-ham + mscale)
    State prop = cur;

    std::vector<State> seg;
    std::vector<double> seg_w;
    for (int depth = 0; depth < m; ++depth) {
      const bool fwd = unif(rng) < 0.5;
      const int n_steps = 1 << depth;
      seg.clear();
      seg_w.clear();
      double w_new_sum = 0.0;
      State prop_new;
      bool have_new = false;
      bool bad = false;

      for (int j = 0; j < n_steps; ++j) {
        State& end = fwd ? sp : sm;
        State in = end;
        if (!fwd)
          for (double& x : in.v) x = -x;
        IgrResult r = adaptive
                          ? r2p_step(target, in, h0, delta, min_c, max_c,
                                     rng)
                          : fixed_step(target, in, h0);
        n_grad += r.n_eval;
        if (adaptive) {
          if (r.i_f < it_min_if) it_min_if = r.i_f;
          if (r.i_f > it_max_if) it_max_if = r.i_f;
        }
        if (!r.finite) {
          bad = true;
          break;
        }
        if (!fwd)
          for (double& x : r.s.v) x = -x;  // back to orbit time
        end = r.s;
        track_state(end);
        double& lwt_sum = fwd ? lwt_sum_f : lwt_sum_b;
        lwt_sum += r.lwt;
        const double w = std::exp(-end.ham + mscale + lwt_sum);
        w_new_sum += w;
        seg.push_back(end);
        seg_w.push_back(w);
        if (w_new_sum > 0.0 && unif(rng) < w / w_new_sum) {
          prop_new = end;
          have_new = true;
        }
      }
      if (bad) break;

      // sub-U-turn scan over the new segment (time order)
      bool sub_ut = false;
      if (n_steps >= 2) {
        // in time order, backward segments are reversed
        auto at = [&](int i) -> State& {
          return fwd ? seg[i] : seg[n_steps - 1 - i];
        };
        for (int span = n_steps; span >= 2 && !sub_ut; span /= 2)
          for (int i = 0; i < n_steps / span; ++i) {
            State& a = at(span * i);
            State& b = at(span * (i + 1) - 1);
            if (uturn(a.q, a.v, b.q, b.v)) {
              sub_ut = true;
              break;
            }
          }
      }
      if (sub_ut) break;

      // biased progressive accept of the new subtree
      if (have_new && unif(rng) < w_new_sum / w_old_sum) prop = prop_new;
      w_old_sum += w_new_sum;

      if (uturn(sm.q, sm.v, sp.q, sp.v)) break;
    }
    cur = prop;
    cur.lp = target.logp_grad(cur.q.data(), cur.g.data());
    it_grads = n_grad - grad0;
    if (it_max_if < 0) {  // no adaptive macro step ran
      it_min_if = 0;
      it_max_if = 0;
    }
  }
};

}  // namespace

extern "C" {

// Run `n_iter` transitions of WALNUTS (adaptive=1, R2P) or multinomial
// NUTS (adaptive=0) from q0; store draws in out [n_iter * dim]
// row-major; return the total number of gradient evaluations.
// diag_out (nullable) gets 6 doubles per iteration: {min If, max If,
// orbit min q[0], orbit max q[0], orbit energy error (max-min H over
// used states; reference diag col 17), grad evals this iteration} —
// the panels of WALNUTSpy_examples/funnel/mainFunnelTransient.py.
long long walnuts_native_run(int target_id, int dim, const double* q0,
                             int n_iter, double h0, double delta, int m,
                             int min_c, int max_c, int adaptive,
                             uint64_t seed, double* out,
                             double* diag_out) {
  Sampler s;
  s.target = Target{target_id, dim};
  s.h0 = h0;
  s.delta = delta;
  s.m = m;
  s.min_c = min_c;
  s.max_c = max_c;
  s.adaptive = adaptive != 0;
  s.rng.seed(seed);
  State cur = s.make_state(q0);
  for (int it = 0; it < n_iter; ++it) {
    s.transition(cur);
    if (out) std::memcpy(out + (size_t)it * dim, cur.q.data(),
                         sizeof(double) * dim);
    if (diag_out) {
      double* row = diag_out + (size_t)it * 6;
      row[0] = s.it_min_if;
      row[1] = s.it_max_if;
      row[2] = s.it_q0_min;
      row[3] = s.it_q0_max;
      row[4] = s.it_ham_max - s.it_ham_min;
      row[5] = (double)s.it_grads;
    }
  }
  return s.n_grad;
}

// Raw leapfrog throughput probe: n total micro steps on the target.
long long walnuts_native_leapfrog_bench(int target_id, int dim,
                                        long long n_steps, double h,
                                        uint64_t seed) {
  Sampler s;
  s.target = Target{target_id, dim};
  s.rng.seed(seed);
  std::normal_distribution<double> norm(0.0, 1.0);
  Vec q(dim);
  for (auto& x : q) x = 0.1 * norm(s.rng);
  State cur = s.make_state(q.data());
  for (auto& x : cur.v) x = norm(s.rng);
  double max_dh = 0.0;
  long long done = 0;
  const long long chunk = 1 << 12;
  while (done < n_steps) {
    const long long n = std::min(chunk, n_steps - done);
    leapfrog(s.target, cur, h, (int)n, &max_dh);
    done += n;
    if (!std::isfinite(cur.ham)) {  // restart on divergence
      for (auto& x : cur.q) x = 0.1 * norm(s.rng);
      for (auto& x : cur.v) x = norm(s.rng);
      cur.lp = s.target.logp_grad(cur.q.data(), cur.g.data());
    }
  }
  return done;
}

}  // extern "C"
