// Independent C++ oracle for the turbo (PCCC) chain.
//
// Role: the reference pinned its BER acceptance constants with an
// independent MATLAB implementation (berTestK7.c:95-100 <-
// scripts/matlab/viterbiBEREstimate.m).  The framework's turbo chain
// gets the same treatment from this file: a self-contained, textbook,
// runtime-parameterized PCCC encoder + iterative max-log-MAP decoder,
// deliberately written in the classic direct form (register arrays,
// flat [state][input] trellis tables, full alpha/beta arrays) rather
// than the JAX build's periodic-impulse / XOR-partner formulations —
// so agreement is evidence, not tautology.
//
// Conventions shared with ops/turbo.py (the code under test):
//   * polynomials over K bits, MSB = current input (Proakis);
//   * state = last S feedback bits, newest at the register head;
//   * termination forces feedback to zero for S steps, tail fields
//     interleaved (x0, z0, x1, z1, ...) per constituent;
//   * LLRs integer, positive favors bit 0; extrinsic scaled by
//     floor(3*le/4) (floor, not truncation, matching Python //).
//
// Exposed extern "C" for ctypes.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <random>
#include <vector>

namespace {

constexpr int64_t kBig = 1ll << 40;

struct RscOracle {
  int K;
  uint32_t gfb, gfw;
  int S() const { return K - 1; }
  int NS() const { return 1 << S(); }

  // Direct-form step on a register vector r[0..S-1] (r[0] = newest
  // feedback bit).  Returns the parity bit; advances the registers.
  int step(std::vector<int>& r, int u, int* w_out) const {
    int fb = 0;
    for (int j = 0; j < S(); ++j)
      if ((gfb >> j) & 1) fb ^= r[S() - 1 - j];
    int w = u ^ fb;
    int z = ((gfw >> (K - 1)) & 1) ? w : 0;
    for (int j = 0; j < S(); ++j)
      if ((gfw >> j) & 1) z ^= r[S() - 1 - j];
    for (int i = S() - 1; i > 0; --i) r[i] = r[i - 1];
    if (S() > 0) r[0] = w;
    *w_out = w;
    return z;
  }

  int feedback_of(const std::vector<int>& r) const {
    int fb = 0;
    for (int j = 0; j < S(); ++j)
      if ((gfb >> j) & 1) fb ^= r[S() - 1 - j];
    return fb;
  }

  std::vector<int> regs_of_state(int s) const {
    // state bit (S-1-i) = r[i]  (newest at the MSB, ops/turbo.py).
    std::vector<int> r(S());
    for (int i = 0; i < S(); ++i) r[i] = (s >> (S() - 1 - i)) & 1;
    return r;
  }

  int state_of_regs(const std::vector<int>& r) const {
    int s = 0;
    for (int i = 0; i < S(); ++i) s |= r[i] << (S() - 1 - i);
    return s;
  }
};

struct Trellis {
  int NS;
  std::vector<int> next;    // [s * 2 + u]
  std::vector<int> par;     // [s * 2 + u]
  explicit Trellis(const RscOracle& c) : NS(c.NS()) {
    next.resize(NS * 2);
    par.resize(NS * 2);
    for (int s = 0; s < NS; ++s) {
      for (int u = 0; u < 2; ++u) {
        auto r = c.regs_of_state(s);
        int w;
        par[s * 2 + u] = c.step(r, u, &w);
        next[s * 2 + u] = c.state_of_regs(r);
      }
    }
  }
};

void rsc_encode(const RscOracle& c, const uint8_t* bits, int L,
                uint8_t* par, uint8_t* tail /* 2*S: x,z,x,z,... */) {
  std::vector<int> r(c.S(), 0);
  int w;
  for (int t = 0; t < L; ++t) par[t] = (uint8_t)c.step(r, bits[t], &w);
  for (int i = 0; i < c.S(); ++i) {
    int u = c.feedback_of(r);           // forces w = 0
    tail[2 * i] = (uint8_t)u;
    tail[2 * i + 1] = (uint8_t)c.step(r, u, &w);
  }
}

int64_t floor_div4(int64_t x) {  // floor(x / 4), Python // semantics
  return (x >= 0) ? x / 4 : -(((-x) + 3) / 4);
}

// A-priori clamp on the extrinsic exchange — part of the algorithm
// (ops/turbo.py LA_CLAMP): bounds the branch metrics far inside the
// int32 metrics.
constexpr int64_t kLaClamp = 1ll << 17;

int64_t clamp_la(int64_t x) {
  return x > kLaClamp ? kLaClamp : (x < -kLaClamp ? -kLaClamp : x);
}

// One constituent max-log-MAP pass: full alpha/beta arrays, tail steps
// with channel-only metrics, state-0 anchors both ends.
void map_pass(const Trellis& tr, int S, const int64_t* lu,
              const int64_t* lp, const int64_t* lt /* 2*S x,z */,
              int L, int64_t* lapp) {
  int NS = tr.NS;
  int T = L + S;
  std::vector<int64_t> gam(T * NS * 2);
  for (int t = 0; t < T; ++t) {
    int64_t l_u = (t < L) ? lu[t] : lt[2 * (t - L)];
    int64_t l_p = (t < L) ? lp[t] : lt[2 * (t - L) + 1];
    for (int s = 0; s < NS; ++s)
      for (int u = 0; u < 2; ++u)
        gam[(t * NS + s) * 2 + u] =
            (int64_t)u * l_u + (int64_t)tr.par[s * 2 + u] * l_p;
  }
  std::vector<int64_t> alpha((T + 1) * NS, kBig), beta((T + 1) * NS, kBig);
  alpha[0] = 0;
  for (int t = 0; t < T; ++t)
    for (int s = 0; s < NS; ++s)
      for (int u = 0; u < 2; ++u) {
        int ns = tr.next[s * 2 + u];
        int64_t v = alpha[t * NS + s] + gam[(t * NS + s) * 2 + u];
        if (v < alpha[(t + 1) * NS + ns]) alpha[(t + 1) * NS + ns] = v;
      }
  beta[T * NS] = 0;
  for (int t = T - 1; t >= 0; --t)
    for (int s = 0; s < NS; ++s)
      for (int u = 0; u < 2; ++u) {
        int ns = tr.next[s * 2 + u];
        int64_t v = beta[(t + 1) * NS + ns] + gam[(t * NS + s) * 2 + u];
        if (v < beta[t * NS + s]) beta[t * NS + s] = v;
      }
  for (int t = 0; t < L; ++t) {
    int64_t m0 = kBig, m1 = kBig;
    for (int s = 0; s < NS; ++s)
      for (int u = 0; u < 2; ++u) {
        int64_t v = alpha[t * NS + s] + gam[(t * NS + s) * 2 + u] +
                    beta[(t + 1) * NS + tr.next[s * 2 + u]];
        if (u) { if (v < m1) m1 = v; } else { if (v < m0) m0 = v; }
      }
    lapp[t] = m1 - m0;
  }
}

void turbo_decode_impl(const RscOracle& c, int L, const int32_t* perm,
                       const int32_t* l_sys, const int32_t* l_par1,
                       const int32_t* l_par2, const int32_t* lt1,
                       const int32_t* lt2, int n_iters, uint8_t* out) {
  Trellis tr(c);
  int S = c.S();
  std::vector<int64_t> lu1(L), lu2(L), lp1(L), lp2(L), t1(2 * S), t2(2 * S);
  std::vector<int64_t> la1(L, 0), la2(L), le(L), lapp1(L), lapp2(L);
  for (int t = 0; t < L; ++t) {
    lp1[t] = l_par1[t];
    lp2[t] = l_par2[t];
  }
  for (int i = 0; i < 2 * S; ++i) {
    t1[i] = lt1[i];
    t2[i] = lt2[i];
  }
  for (int it = 0; it < n_iters; ++it) {
    for (int t = 0; t < L; ++t) lu1[t] = (int64_t)l_sys[t] + la1[t];
    map_pass(tr, S, lu1.data(), lp1.data(), t1.data(), L, lapp1.data());
    for (int t = 0; t < L; ++t)
      le[t] = lapp1[t] - (int64_t)l_sys[t] - la1[t];
    for (int t = 0; t < L; ++t) la2[t] = clamp_la(floor_div4(3 * le[perm[t]]));
    for (int t = 0; t < L; ++t)
      lu2[t] = (int64_t)l_sys[perm[t]] + la2[t];
    map_pass(tr, S, lu2.data(), lp2.data(), t2.data(), L, lapp2.data());
    for (int t = 0; t < L; ++t)
      le[t] = lapp2[t] - (int64_t)l_sys[perm[t]] - la2[t];
    for (int t = 0; t < L; ++t) la1[perm[t]] = clamp_la(floor_div4(3 * le[t]));
  }
  // de-interleave the final a-posteriori
  for (int t = 0; t < L; ++t) out[perm[t]] = lapp2[t] < 0 ? 1 : 0;
}

}  // namespace

extern "C" {

// Encode one block: sys = bits; par1/par2 [L]; tail1/tail2 [2*S] as
// (x0, z0, x1, z1, ...).
void turbo_oracle_encode(int K, uint32_t gfb, uint32_t gfw,
                         const uint8_t* bits, int L, const int32_t* perm,
                         uint8_t* par1, uint8_t* par2,
                         uint8_t* tail1, uint8_t* tail2) {
  RscOracle c{K, gfb, gfw};
  rsc_encode(c, bits, L, par1, tail1);
  std::vector<uint8_t> ib(L);
  for (int t = 0; t < L; ++t) ib[t] = bits[perm[t]];
  rsc_encode(c, ib.data(), L, par2, tail2);
}

void turbo_oracle_decode(int K, uint32_t gfb, uint32_t gfw, int L,
                         const int32_t* perm, const int32_t* l_sys,
                         const int32_t* l_par1, const int32_t* l_par2,
                         const int32_t* l_tail1, const int32_t* l_tail2,
                         int n_iters, uint8_t* out) {
  RscOracle c{K, gfb, gfw};
  turbo_decode_impl(c, L, perm, l_sys, l_par1, l_par2, l_tail1, l_tail2,
                    n_iters, out);
}

// Self-contained BER/BLER campaign at one AWGN/BPSK operating point:
// random blocks, rate-1/3 transmission (sys, par1, par2 + 12 tail
// bits), exact LLRs, the harness' 3-sigma AGC quantizer, max-log
// decode.  Fills bit_errors and block_errors.
void turbo_oracle_ber_point(int K, uint32_t gfb, uint32_t gfw, int L,
                            const int32_t* perm, double ebn0_db, int qmax,
                            int n_blocks, int n_iters, uint64_t seed,
                            int64_t* bit_errors, int32_t* block_errors) {
  RscOracle c{K, gfb, gfw};
  int S = c.S();
  int E = 3 * L + 4 * S;                     // transmitted bits per block
  double rate = (double)L / (double)E;
  double esn0 = std::pow(10.0, ebn0_db / 10.0) * rate;
  double sigma = std::sqrt(1.0 / (2.0 * esn0));
  std::mt19937_64 rng(seed);
  std::normal_distribution<double> gauss(0.0, 1.0);
  std::uniform_int_distribution<int> coin(0, 1);

  *bit_errors = 0;
  *block_errors = 0;
  std::vector<uint8_t> bits(L), par1(L), par2(L), t1(2 * S), t2(2 * S);
  std::vector<uint8_t> out(L);
  std::vector<double> llr(E);
  std::vector<int32_t> q(E);
  for (int blk = 0; blk < n_blocks; ++blk) {
    for (int t = 0; t < L; ++t) bits[t] = (uint8_t)coin(rng);
    turbo_oracle_encode(K, gfb, gfw, bits.data(), L, perm, par1.data(),
                        par2.data(), t1.data(), t2.data());
    auto tx = [&](int i, uint8_t b) {
      double y = (1.0 - 2.0 * (double)b) + sigma * gauss(rng);
      llr[i] = 4.0 * esn0 * y;
    };
    int i = 0;
    for (int t = 0; t < L; ++t) tx(i++, bits[t]);
    for (int t = 0; t < L; ++t) tx(i++, par1[t]);
    for (int t = 0; t < L; ++t) tx(i++, par2[t]);
    for (int j = 0; j < 2 * S; ++j) tx(i++, t1[j]);
    for (int j = 0; j < 2 * S; ++j) tx(i++, t2[j]);
    // 3-sigma AGC quantizer (ops/metrics.py quantize_llrs)
    double ms = 0.0;
    for (int j = 0; j < E; ++j) ms += llr[j] * llr[j];
    double scale = 3.0 * std::sqrt(ms / E) / (double)qmax;
    if (scale < 1e-9) scale = 1e-9;
    for (int j = 0; j < E; ++j) {
      double v = std::nearbyint(llr[j] / scale);
      if (v > qmax) v = qmax;
      if (v < -qmax) v = -qmax;
      q[j] = (int32_t)v;
    }
    turbo_oracle_decode(K, gfb, gfw, L, perm, q.data(), q.data() + L,
                        q.data() + 2 * L, q.data() + 3 * L,
                        q.data() + 3 * L + 2 * S, n_iters, out.data());
    int be = 0;
    for (int t = 0; t < L; ++t) be += (out[t] != bits[t]);
    *bit_errors += be;
    *block_errors += (be > 0);
  }
}

}  // extern "C"
