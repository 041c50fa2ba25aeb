// Independent C++ oracle codec for convolutionalencdec.
//
// Role: the reference validated its C codec against MATLAB's convenc/vitdec
// (scripts/matlab/viterbiBEREstimate.m); this framework validates its
// JAX/Pallas codec against this self-contained C++ implementation — golden
// values computed by an independent implementation (SURVEY.md §4 item 4).
//
// Deliberately textbook-style and runtime-parameterized: dynamic K/k/n and
// generators, std::vector state, full-block traceback, int32 metrics, no
// macro configuration and no SIMD — favoring obviousness over speed so it
// can serve as ground truth.  Exposed extern "C" for ctypes.
//
// Conventions (must match convolutionalencdec/params.py):
//   * generators in Proakis big-endian order over k*K bits (MSB = newest
//     input bit);
//   * shift register shifts new bits into the LSb;
//   * segment packs generator j's output at bit j;
//   * termination: S = K-1 all-zero input steps returning to state 0;
//   * initial metrics: 0 for state 0, min(num_states + 1, 200) otherwise;
//   * ACS tie-break selects the lowest decision index.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

int popcount64(uint64_t x) {
  int c = 0;
  for (; x; x >>= 1) c += static_cast<int>(x & 1);
  return c;
}

uint64_t reverse_bits(uint64_t v, int width) {
  uint64_t out = 0;
  for (int i = 0; i < width; ++i) {
    out = (out << 1) | (v & 1);
    v >>= 1;
  }
  return out;
}

struct Code {
  int K, k, n;
  std::vector<uint64_t> g_rev;  // LSb taps the newest input bit
  int S() const { return K - 1; }
  int num_states() const { return 1 << (k * S()); }
  int delay_width() const { return k * K; }

  // One trellis step: shift k input bits (MSb of u first) into `state`,
  // return the n-bit coded segment and the successor state.
  uint8_t step(int state, int u, int* next_state) const {
    uint64_t delay =
        ((static_cast<uint64_t>(state) << k) | static_cast<uint64_t>(u)) &
        ((1ull << delay_width()) - 1);
    uint8_t seg = 0;
    for (int j = 0; j < n; ++j) {
      seg |= static_cast<uint8_t>((popcount64(delay & g_rev[j]) & 1) << j);
    }
    *next_state = static_cast<int>(delay & (num_states() - 1));
    return seg;
  }
};

Code make_code(int K, int k, int n, const uint64_t* g) {
  Code c;
  c.K = K;
  c.k = k;
  c.n = n;
  c.g_rev.resize(n);
  for (int j = 0; j < n; ++j) c.g_rev[j] = reverse_bits(g[j], k * K);
  return c;
}

}  // namespace

extern "C" {

// Encode `num_bits` 0/1 bytes (a multiple of k) into n-bit segments, one
// uint8 per segment.  If `terminate`, appends S zero-input steps.  Returns
// the number of segments written.
int fec_oracle_encode(int K, int k, int n, const uint64_t* g,
                      const uint8_t* bits, int num_bits, int terminate,
                      uint8_t* out_segments) {
  Code c = make_code(K, k, n, g);
  int state = 0;
  int t = 0;
  for (int i = 0; i < num_bits; i += k) {
    int u = 0;
    for (int j = 0; j < k; ++j) u = (u << 1) | bits[i + j];
    out_segments[t++] = c.step(state, u, &state);
  }
  if (terminate) {
    for (int s = 0; s < c.S(); ++s) out_segments[t++] = c.step(state, 0, &state);
  }
  return t;
}

// Hard-decision Viterbi block decode of a terminated packet of
// `num_segments` segments; writes (num_segments - S) * k bits.  Returns
// the number of bits written.
int fec_oracle_decode(int K, int k, int n, const uint64_t* g,
                      const uint8_t* segments, int num_segments,
                      uint8_t* out_bits) {
  Code c = make_code(K, k, n, g);
  const int NS = c.num_states();
  const int E = 1 << k;
  const int init_hi = NS + 1 < 200 ? NS + 1 : 200;

  // Trellis derived from the encoder, like viterbiInit does from
  // convEncOneInput (viterbiDecoder.c:32-50).
  std::vector<uint8_t> edge_seg(static_cast<size_t>(NS) * E);
  std::vector<int> next_state(static_cast<size_t>(NS) * E);
  for (int s = 0; s < NS; ++s) {
    for (int u = 0; u < E; ++u) {
      int ns;
      edge_seg[static_cast<size_t>(s) * E + u] = c.step(s, u, &ns);
      next_state[static_cast<size_t>(s) * E + u] = ns;
    }
  }

  std::vector<int32_t> metric(NS, init_hi), next_metric(NS);
  metric[0] = 0;
  // decisions[t][dst] = chosen decision index e (the k shifted-out bits
  // of the winning source).
  std::vector<uint8_t> decisions(static_cast<size_t>(num_segments) * NS);

  const int shift = (c.S() - 1) * k;
  for (int t = 0; t < num_segments; ++t) {
    uint8_t r = segments[t];
    for (int dst = 0; dst < NS; ++dst) {
      int u = dst & (E - 1);  // input bits of every edge entering dst
      int32_t best = INT32_MAX;
      uint8_t best_e = 0;
      for (int e = 0; e < E; ++e) {
        int src = (dst >> k) | (e << shift);
        uint8_t cs = edge_seg[static_cast<size_t>(src) * E + u];
        int bm = popcount64(static_cast<uint64_t>(cs ^ r));
        int32_t m = metric[src] + bm;
        if (m < best) {  // strict: ties keep the lowest e
          best = m;
          best_e = static_cast<uint8_t>(e);
        }
      }
      next_metric[dst] = best;
      decisions[static_cast<size_t>(t) * NS + dst] = best_e;
    }
    metric.swap(next_metric);
  }

  // Block traceback from the known terminal state 0, dropping the S
  // zero-pad steps.
  int cur = 0;
  int out_len = (num_segments - c.S()) * k;
  for (int t = num_segments - 1; t >= 0; --t) {
    int u = cur & (E - 1);
    int e = decisions[static_cast<size_t>(t) * NS + cur];
    if (t < num_segments - c.S()) {
      for (int j = 0; j < k; ++j) {
        out_bits[t * k + (k - 1 - j)] = static_cast<uint8_t>((u >> j) & 1);
      }
    }
    cur = (cur >> k) | (e << shift);
  }
  return out_len;
}

}  // extern "C"
