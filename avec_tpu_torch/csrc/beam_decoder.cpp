// CTC prefix beam search with ARPA n-gram shallow fusion, on the host (a
// copy of avec_tpu/csrc/beam_decoder.cpp for avec_tpu_torch; bound through
// ctypes by avec_tpu_torch/decode/native.py, which builds it with
// g++ -O3 -std=c++17 -shared -fPIC at first use).
//
// The same algorithm as avec_tpu_torch/decode/beam.py's Python search:
// prefix beam search over (T, V) log-probs, Katz back-off scoring of an ARPA
// model (order <= 6) whose words are the token remapping chr(id + offset),
// and alpha * ln(10) * log10 P + beta added per extension.
//
//   * the ARPA vocabulary is interned to integer word ids at load time and
//     n-grams are keyed by packed 128-bit integer keys; a query costs
//     O(order) hash probes
//   * per-frame candidate pruning: cutoff_top_n / cutoff_prob (tokens sorted
//     by prob, stop at cumulative cutoff_prob, cap at cutoff_top_n; off by
//     default)
//   * bd_decode_batch decodes a batch of utterances on a thread pool
//
// Exposed as a C ABI for ctypes.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <fstream>
#include <limits>
#include <memory>
#include <sstream>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

constexpr double kNegInf = -std::numeric_limits<double>::infinity();
constexpr double kLn10 = 2.302585092994046;

inline double LogSumExp2(double a, double b) {
  if (a == kNegInf) return b;
  if (b == kNegInf) return a;
  double m = a > b ? a : b;
  return m + std::log(std::exp(a - m) + std::exp(b - m));
}

// UTF-8 encoding of a unicode codepoint (token id + offset), matching
// Python's chr().
std::string CodepointUtf8(int cp) {
  std::string out;
  if (cp < 0x80) {
    out.push_back(static_cast<char>(cp));
  } else if (cp < 0x800) {
    out.push_back(static_cast<char>(0xC0 | (cp >> 6)));
    out.push_back(static_cast<char>(0x80 | (cp & 0x3F)));
  } else {
    out.push_back(static_cast<char>(0xE0 | (cp >> 12)));
    out.push_back(static_cast<char>(0x80 | ((cp >> 6) & 0x3F)));
    out.push_back(static_cast<char>(0x80 | (cp & 0x3F)));
  }
  return out;
}

// --------------------------------------------------------------------------
// ARPA backoff LM over interned integer word ids.
//
// N-grams (order <= 6, word ids < 2^21 - 1) are packed into a 128-bit key:
// each 21-bit slot holds id+1 (0 = empty), slot i = gram word i. Injective,
// so lookups are exact — no collision risk.
// --------------------------------------------------------------------------
struct Key128 {
  uint64_t lo = 0, hi = 0;
  bool operator==(const Key128& o) const { return lo == o.lo && hi == o.hi; }
};

struct Key128Hash {
  size_t operator()(const Key128& k) const {
    uint64_t h = k.lo * 0x9e3779b97f4a7c15ull;
    h ^= (k.hi + 0x9e3779b97f4a7c15ull + (h << 6) + (h >> 2));
    h *= 0xff51afd7ed558ccdull;
    h ^= h >> 33;
    return static_cast<size_t>(h);
  }
};

constexpr int kSlotBits = 21;
constexpr uint32_t kMaxWordId = (1u << kSlotBits) - 2;  // id+1 must fit

inline void KeyPush(Key128& k, int slot, uint32_t word_id) {
  uint64_t v = static_cast<uint64_t>(word_id) + 1;
  int bit = slot * kSlotBits;
  if (bit < 64) {
    k.lo |= v << bit;
    if (bit + kSlotBits > 64) k.hi |= v >> (64 - bit);
  } else {
    k.hi |= v << (bit - 64);
  }
}

inline Key128 MakeKey(const uint32_t* ids, int n) {
  Key128 k;
  for (int i = 0; i < n; ++i) KeyPush(k, i, ids[i]);
  return k;
}

class ArpaLM {
 public:
  explicit ArpaLM(const std::string& path) {
    std::ifstream f(path);
    if (!f) throw std::runtime_error("cannot open " + path);
    std::string line;
    int section = 0;
    std::vector<std::string> words;
    std::vector<uint32_t> ids;
    while (std::getline(f, line)) {
      while (!line.empty() && (line.back() == '\r' || line.back() == ' '))
        line.pop_back();
      if (line.empty()) continue;
      if (line[0] == '\\') {
        auto g = line.find("-grams:");
        if (g != std::string::npos) {
          section = std::stoi(line.substr(1, g - 1));
          if (section > order_) order_ = section;
        } else {
          section = 0;
        }
        continue;
      }
      if (section == 0) continue;
      std::istringstream ss(line);
      double logp;
      if (!(ss >> logp)) continue;
      words.assign(section, "");
      ids.resize(section);
      for (int i = 0; i < section; ++i) ss >> words[i];
      for (int i = 0; i < section; ++i) ids[i] = Intern(words[i]);
      double backoff = 0.0;
      bool has_backoff = static_cast<bool>(ss >> backoff);
      Key128 key = MakeKey(ids.data(), section);
      probs_[key] = logp;
      if (has_backoff) backoffs_[key] = backoff;
    }
    if (order_ > 6)
      throw std::runtime_error("ARPA order > 6 unsupported by 128-bit keys");
  }

  int order() const { return order_; }

  // Vocabulary id for a word string; kUnk if the LM never saw it.
  static constexpr uint32_t kUnk = 0xFFFFFFFFu;
  uint32_t WordId(const std::string& w) const {
    auto it = vocab_.find(w);
    return it == vocab_.end() ? kUnk : it->second;
  }

  // log10 P(word | history) with Katz backoff. `history` holds the most
  // recent (<= order-1) word ids, oldest first; kUnk entries break context.
  // `matched_len` (optional out) returns the length of the n-gram that
  // matched — the KenLM-style state: by the ARPA suffix-closure property
  // (every suffix of a stored n-gram is stored, structurally guaranteed by
  // KenLM/SRILM outputs), the next query's history can start at this length
  // and skip guaranteed-miss probes without changing any score.
  double Log10Cond(const uint32_t* history, int hist_len, uint32_t word,
                   int* matched_len = nullptr) const {
    if (word == kUnk) {
      if (matched_len) *matched_len = 0;
      return -99.0;
    }
    if (hist_len > order_ - 1) {
      history += hist_len - (order_ - 1);
      hist_len = order_ - 1;
    }
    // An unseen word in the history cannot match any stored n-gram; start
    // the context after the last unknown.
    for (int i = hist_len - 1; i >= 0; --i) {
      if (history[i] == kUnk) {
        history += i + 1;
        hist_len -= i + 1;
        break;
      }
    }
    double bo_sum = 0.0;
    uint32_t gram[7];
    while (true) {
      for (int i = 0; i < hist_len; ++i) gram[i] = history[i];
      gram[hist_len] = word;
      auto it = probs_.find(MakeKey(gram, hist_len + 1));
      if (it != probs_.end()) {
        if (matched_len) *matched_len = hist_len + 1;
        return bo_sum + it->second;
      }
      if (hist_len == 0) {
        if (matched_len) *matched_len = 0;
        return bo_sum - 99.0;  // unseen unigram
      }
      auto bo = backoffs_.find(MakeKey(history, hist_len));
      if (bo != backoffs_.end()) bo_sum += bo->second;
      ++history;
      --hist_len;
    }
  }

 private:
  uint32_t Intern(const std::string& w) {
    auto it = vocab_.find(w);
    if (it != vocab_.end()) return it->second;
    uint32_t id = static_cast<uint32_t>(vocab_.size());
    if (id > kMaxWordId)
      throw std::runtime_error("ARPA vocabulary exceeds 2^21-2 words");
    vocab_.emplace(w, id);
    return id;
  }

  std::unordered_map<std::string, uint32_t> vocab_;
  std::unordered_map<Key128, double, Key128Hash> probs_;
  std::unordered_map<Key128, double, Key128Hash> backoffs_;
  int order_ = 0;
};

// --------------------------------------------------------------------------
// Prefix beam search.
// --------------------------------------------------------------------------
struct BeamState {
  double p_blank = kNegInf;
  double p_non_blank = kNegInf;
  double lm_score = 0.0;
};

struct Decoder {
  int blank;
  int beam_size;
  double alpha;
  double beta;
  int offset;
  int cutoff_top_n = 0;      // 0 = off (all V tokens)
  double cutoff_prob = 1.0;  // 1.0 = off
  std::unique_ptr<ArpaLM> lm;
  // token id -> LM word id (chr(id + offset) interned), built lazily on the
  // first decode for the observed V.
  mutable std::vector<uint32_t> token_word_ids;

  void EnsureTokenTable(int V) const {
    if (!lm || static_cast<int>(token_word_ids.size()) >= V) return;
    token_word_ids.resize(V);
    for (int id = 0; id < V; ++id)
      token_word_ids[id] = lm->WordId(CodepointUtf8(id + offset));
  }
};

using Prefix = std::vector<int32_t>;

// Prefixes live in a trie: a beam is a node id, extension by token c is a
// child lookup keyed by (parent, c) — no per-extension vector copies or
// O(len) hashing. Node 0 is the empty prefix.
struct PrefixTrie {
  struct Node {
    int32_t parent;
    int32_t token;
    int32_t depth;
  };
  std::vector<Node> nodes{{-1, -1, 0}};
  std::unordered_map<uint64_t, int32_t> children;

  int32_t Child(int32_t parent, int32_t token) {
    uint64_t key = (static_cast<uint64_t>(parent) << 32) |
                   static_cast<uint32_t>(token);
    auto it = children.find(key);
    if (it != children.end()) return it->second;
    int32_t id = static_cast<int32_t>(nodes.size());
    nodes.push_back({parent, token, nodes[parent].depth + 1});
    children.emplace(key, id);
    return id;
  }

  int32_t LastToken(int32_t node) const { return nodes[node].token; }

  // Most recent `n` tokens of the prefix, oldest first; returns count.
  int Tail(int32_t node, int n, int32_t* out) const {
    int cnt = 0;
    int32_t cur = node;
    while (cur != 0 && cnt < n) {
      out[cnt++] = nodes[cur].token;
      cur = nodes[cur].parent;
    }
    std::reverse(out, out + cnt);
    return cnt;
  }

  Prefix Materialize(int32_t node) const {
    Prefix p(nodes[node].depth);
    int32_t cur = node;
    for (int i = nodes[node].depth - 1; i >= 0; --i) {
      p[i] = nodes[cur].token;
      cur = nodes[cur].parent;
    }
    return p;
  }
};

// alpha * ln P_lm(c | prefix tail) + beta. O(order): reads only the last
// min(ctx_len, order-1) prefix tokens (ctx_len = KenLM-style state: length
// of the n-gram matched by this prefix's previous query — longer contexts
// are guaranteed misses, see ArpaLM::Log10Cond). Returns the score and the
// extended prefix's new ctx_len via `new_ctx`.
double LmAdd(const Decoder& d, const PrefixTrie& trie, int32_t node,
             int ctx_len, int c, uint8_t* new_ctx) {
  if (!d.lm) {
    *new_ctx = 0;
    return 0.0;
  }
  int32_t tail[8];
  uint32_t hist[8];
  int want = std::min(ctx_len, d.lm->order() - 1);
  int hist_len = trie.Tail(node, want, tail);
  for (int i = 0; i < hist_len; ++i) hist[i] = d.token_word_ids[tail[i]];
  int matched = 0;
  double log10p =
      d.lm->Log10Cond(hist, hist_len, d.token_word_ids[c], &matched);
  *new_ctx = static_cast<uint8_t>(matched);
  return d.alpha * log10p * kLn10 + d.beta;
}

// Per-frame candidate pruning (ctcdecode get_pruned_log_probs semantics):
// tokens sorted by prob desc, keep until cumulative prob exceeds
// cutoff_prob, capped at cutoff_top_n; the blank is always considered.
void PruneCandidates(const Decoder& d, const float* row, int V,
                     std::vector<int>& cand) {
  cand.clear();
  bool use_top_n = d.cutoff_top_n > 0 && d.cutoff_top_n < V;
  bool use_prob = d.cutoff_prob < 1.0;
  if (!use_top_n && !use_prob) {
    for (int c = 0; c < V; ++c) cand.push_back(c);
    return;
  }
  std::vector<std::pair<float, int>> order(V);
  for (int c = 0; c < V; ++c) order[c] = {row[c], c};
  int cap = use_top_n ? d.cutoff_top_n : V;
  std::partial_sort(order.begin(), order.begin() + cap, order.end(),
                    [](const auto& a, const auto& b) { return a.first > b.first; });
  double cum = 0.0;
  for (int i = 0; i < cap; ++i) {
    cand.push_back(order[i].second);
    cum += std::exp(static_cast<double>(order[i].first));
    if (use_prob && cum > d.cutoff_prob) break;
  }
  if (std::find(cand.begin(), cand.end(), d.blank) == cand.end())
    cand.push_back(d.blank);
}

// Returns beams sorted best-first: (prefix, total combined log-likelihood).
std::vector<std::pair<Prefix, double>> PrefixBeamSearch(
    const Decoder& d, const float* logp, int T, int V, int seq_len) {
  d.EnsureTokenTable(V);
  PrefixTrie trie;
  struct Entry {
    int32_t node;
    BeamState st;
    uint8_t ctx_len;  // KenLM-style LM state of this prefix
  };
  std::vector<Entry> beams{{0, BeamState{0.0, kNegInf, 0.0}, 0}};
  std::vector<int> cand;
  // next beams keyed by trie node id.
  std::unordered_map<int32_t, int32_t> index;  // node -> slot in `next`
  std::vector<Entry> next;
  std::vector<std::pair<double, int32_t>> scored;  // (score, slot)

  auto acc = [&](int32_t node, double pb, double pnb, double lm,
                 uint8_t ctx) {
    auto [it, inserted] = index.emplace(node, static_cast<int32_t>(next.size()));
    if (inserted)
      next.push_back({node, BeamState{kNegInf, kNegInf, lm}, ctx});
    BeamState& st = next[it->second].st;
    st.p_blank = LogSumExp2(st.p_blank, pb);
    st.p_non_blank = LogSumExp2(st.p_non_blank, pnb);
  };

  for (int t = 0; t < seq_len && t < T; ++t) {
    const float* row = logp + static_cast<int64_t>(t) * V;
    PruneCandidates(d, row, V, cand);
    index.clear();
    next.clear();
    index.reserve(beams.size() * (cand.size() + 1));
    next.reserve(beams.size() * (cand.size() + 1));

    for (const Entry& e : beams) {
      const BeamState& st = e.st;
      double total = LogSumExp2(st.p_blank, st.p_non_blank);
      int last = trie.LastToken(e.node);
      for (int c : cand) {
        double p = row[c];
        if (c == d.blank) {
          acc(e.node, total + p, kNegInf, st.lm_score, e.ctx_len);
        } else if (c == last) {
          acc(e.node, kNegInf, st.p_non_blank + p, st.lm_score, e.ctx_len);
          if (st.p_blank != kNegInf) {
            uint8_t ctx;
            double add = LmAdd(d, trie, e.node, e.ctx_len, c, &ctx);
            acc(trie.Child(e.node, c), kNegInf, st.p_blank + p,
                st.lm_score + add, ctx);
          }
        } else {
          uint8_t ctx;
          double add = LmAdd(d, trie, e.node, e.ctx_len, c, &ctx);
          acc(trie.Child(e.node, c), kNegInf, total + p, st.lm_score + add,
              ctx);
        }
      }
    }

    // Prune to beam_size by combined score.
    scored.clear();
    scored.reserve(next.size());
    for (int32_t i = 0; i < static_cast<int32_t>(next.size()); ++i) {
      double s = LogSumExp2(next[i].st.p_blank, next[i].st.p_non_blank) +
                 next[i].st.lm_score;
      scored.emplace_back(s, i);
    }
    int keep = std::min<int>(d.beam_size, scored.size());
    std::partial_sort(scored.begin(), scored.begin() + keep, scored.end(),
                      [](const auto& a, const auto& b) { return a.first > b.first; });
    beams.clear();
    beams.reserve(keep);
    for (int i = 0; i < keep; ++i) beams.push_back(next[scored[i].second]);
  }

  std::vector<std::pair<Prefix, double>> out;
  out.reserve(beams.size());
  for (const Entry& e : beams) {
    double s = LogSumExp2(e.st.p_blank, e.st.p_non_blank) + e.st.lm_score;
    out.emplace_back(trie.Materialize(e.node), s);
  }
  std::sort(out.begin(), out.end(),
            [](const auto& a, const auto& b) { return a.second > b.second; });
  return out;
}

void WriteBeams(const Decoder& d,
                const std::vector<std::pair<Prefix, double>>& beams,
                int32_t* out_tokens, int32_t* out_lens, double* out_scores,
                int max_out_len) {
  int n = std::min<int>(d.beam_size, beams.size());
  for (int i = 0; i < n; ++i) {
    const auto& prefix = beams[i].first;
    int len = std::min<int>(prefix.size(), max_out_len);
    std::memcpy(out_tokens + static_cast<int64_t>(i) * max_out_len,
                prefix.data(), len * sizeof(int32_t));
    out_lens[i] = len;
    out_scores[i] = beams[i].second;
  }
  for (int i = n; i < d.beam_size; ++i) {
    out_lens[i] = 0;
    out_scores[i] = kNegInf;
  }
}

}  // namespace

extern "C" {

void* bd_create(int blank, int beam_size, double alpha, double beta,
                const char* arpa_path, int offset) {
  auto* d = new Decoder{blank, beam_size, alpha, beta, offset};
  if (arpa_path != nullptr && arpa_path[0] != '\0') {
    try {
      d->lm = std::make_unique<ArpaLM>(arpa_path);
    } catch (...) {
      delete d;
      return nullptr;
    }
  }
  return d;
}

// Candidate pruning knobs (cutoff_top_n / cutoff_prob); top_n <= 0 and
// prob >= 1.0 disable them (the default).
void bd_set_cutoff(void* handle, int cutoff_top_n, double cutoff_prob) {
  auto* d = static_cast<Decoder*>(handle);
  d->cutoff_top_n = cutoff_top_n;
  d->cutoff_prob = cutoff_prob;
}

void bd_destroy(void* handle) { delete static_cast<Decoder*>(handle); }

// Decode one utterance. Outputs: out_tokens (beam_size x max_out_len int32),
// out_lens (beam_size int32), out_scores (beam_size double, total combined
// log-likelihood, higher = better). Returns number of beams produced.
int bd_decode(void* handle, const float* logp, int T, int V, int seq_len,
              int32_t* out_tokens, int32_t* out_lens, double* out_scores,
              int max_out_len) {
  auto* d = static_cast<Decoder*>(handle);
  auto beams = PrefixBeamSearch(*d, logp, T, V, seq_len);
  WriteBeams(*d, beams, out_tokens, out_lens, out_scores, max_out_len);
  return std::min<int>(d->beam_size, beams.size());
}

// Decode a batch of utterances on a thread pool. logp is (B, T, V) contiguous; seq_lens (B,).
// Outputs are (B, beam_size, ...) slabs. Utterances are distributed over
// min(num_threads, B) worker threads via an atomic work queue (the Decoder
// is read-only during decode once the token table is built).
void bd_decode_batch(void* handle, const float* logp, int B, int T, int V,
                     const int32_t* seq_lens, int32_t* out_tokens,
                     int32_t* out_lens, double* out_scores, int max_out_len,
                     int num_threads) {
  auto* d = static_cast<Decoder*>(handle);
  d->EnsureTokenTable(V);  // build once, before the threads share it
  const int64_t utt_stride = static_cast<int64_t>(T) * V;
  const int64_t tok_stride =
      static_cast<int64_t>(d->beam_size) * max_out_len;
  std::atomic<int> next_utt{0};
  auto worker = [&]() {
    for (;;) {
      int b = next_utt.fetch_add(1);
      if (b >= B) return;
      auto beams = PrefixBeamSearch(*d, logp + b * utt_stride, T, V,
                                    seq_lens[b]);
      WriteBeams(*d, beams, out_tokens + b * tok_stride,
                 out_lens + static_cast<int64_t>(b) * d->beam_size,
                 out_scores + static_cast<int64_t>(b) * d->beam_size,
                 max_out_len);
    }
  };
  int n_threads = std::max(1, std::min(num_threads, B));
  if (n_threads == 1) {
    worker();
    return;
  }
  std::vector<std::thread> pool;
  pool.reserve(n_threads);
  for (int i = 0; i < n_threads; ++i) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
}

}  // extern "C"
