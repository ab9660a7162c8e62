// Native batch sampler for sagnn_tpu_torch (the port's own copy of
// sagnn_tpu/native/sampler.cc; the same code, so the same seeds give the
// same batches byte for byte).
//
// Replaces the host hot loops of the reference trainer (model.py:252-339:
// per-user Python rejection sampling + sequence padding dominated host time,
// SURVEY.md §3.2). Exposed as a C ABI consumed via ctypes
// (sagnn_tpu_torch/data/native_sampler.py). Semantics match the numpy
// sampler in sagnn_tpu_torch/data/sampler.py:
//   * positives: one target item sequence[-choose] repeated samp times,
//     choose ~ U[1, max(min(pred_num+1, len-3), 1)]
//   * negatives: uniform rejection over items, excluding the user's train
//     row (CSR membership), the last sequence item, and the test item
//   * ssl: per interval, min(ssl_num, row/2) pairs of interacted items drawn
//     with replacement, reference interleave-then-halve layout pre-split
//
// Build: lazily by sagnn_tpu_torch/data/native_sampler.py
// (g++ -O3 -march=native -std=c++17 -fPIC -shared).

#include <algorithm>
#include <cstdint>
#include <cstring>

namespace {

// splitmix64 + xoshiro256** — deterministic, seedable, fast.
struct Rng {
  uint64_t s[4];
  explicit Rng(uint64_t seed) {
    uint64_t x = seed;
    for (int i = 0; i < 4; i++) {
      x += 0x9e3779b97f4a7c15ULL;
      uint64_t z = x;
      z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
      z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
      s[i] = z ^ (z >> 31);
    }
  }
  static uint64_t rotl(uint64_t v, int k) { return (v << k) | (v >> (64 - k)); }
  uint64_t next() {
    uint64_t result = rotl(s[1] * 5, 7) * 9;
    uint64_t t = s[1] << 17;
    s[2] ^= s[0];
    s[3] ^= s[1];
    s[1] ^= s[2];
    s[0] ^= s[3];
    s[2] ^= t;
    s[3] = rotl(s[3], 45);
    return result;
  }
  // unbiased bounded draw (Lemire)
  uint32_t bounded(uint32_t n) {
    uint64_t m = (uint64_t)(uint32_t)next() * n;
    uint32_t l = (uint32_t)m;
    if (l < n) {
      uint32_t t = (uint32_t)(-(int32_t)n) % n;
      while (l < t) {
        m = (uint64_t)(uint32_t)next() * n;
        l = (uint32_t)m;
      }
    }
    return (uint32_t)(m >> 32);
  }
};

// membership test in a sorted CSR row
inline bool row_contains(const int32_t* indices, int64_t lo, int64_t hi,
                         int32_t item) {
  const int32_t* first = indices + lo;
  const int32_t* last = indices + hi;
  const int32_t* it = std::lower_bound(first, last, item);
  return it != last && *it == item;
}

inline void fill_sequence(const int32_t* items, int64_t n, int32_t pos_length,
                          int32_t* seq_row, float* mask_row) {
  std::memset(seq_row, 0, sizeof(int32_t) * pos_length);
  std::memset(mask_row, 0, sizeof(float) * pos_length);
  if (n <= 0) return;
  if (n <= pos_length) {
    std::memcpy(seq_row + (pos_length - n), items, sizeof(int32_t) * n);
    for (int64_t j = pos_length - n; j < pos_length; j++) mask_row[j] = 1.0f;
  } else {
    std::memcpy(seq_row, items + (n - pos_length),
                sizeof(int32_t) * pos_length);
    for (int64_t j = 0; j < pos_length; j++) mask_row[j] = 1.0f;
  }
}

}  // namespace

extern "C" {

// Train batch. Arrays sized as noted; P = batch_cap * samp_num.
// Returns number of real pairs written.
//
// Determinism contract (multi-process data parallelism): user i's draws
// come from an RNG seeded by mix(seed, user_id) and land in the FIXED slot
// range [i*samp_num, (i+1)*samp_num), so sampling any SLICE of a batch
// with the same seed yields exactly the rows the full-batch call would —
// each host samples only the batch rows its devices own
// and the assembled global batch is
// bit-identical to a single-host run.
int64_t sample_train_batch(
    uint64_t seed,
    const int32_t* bat_ids, int64_t batch,        // user ids, count
    int64_t batch_cap,                            // B rows in seq/mask
    const int64_t* seq_offsets,                   // [num_users+1] ragged seq
    const int32_t* seq_items,                     // flattened sequences
    const int64_t* trn_indptr, const int32_t* trn_indices,  // train CSR
    const int32_t* tst_int,                       // [num_users], -1 if none
    int32_t num_items, int32_t samp_num, int32_t pred_num,
    int32_t pos_length,
    // outputs
    int32_t* uids, int32_t* pos_iids, int32_t* neg_iids, int32_t* useq_row,
    float* pair_mask, int32_t* seq, float* mask) {
  const int64_t P = batch_cap * (int64_t)samp_num;
  std::memset(uids, 0, sizeof(int32_t) * P);
  std::memset(pos_iids, 0, sizeof(int32_t) * P);
  std::memset(neg_iids, 0, sizeof(int32_t) * P);
  std::memset(useq_row, 0, sizeof(int32_t) * P);
  std::memset(pair_mask, 0, sizeof(float) * P);
  std::memset(seq, 0, sizeof(int32_t) * batch_cap * pos_length);
  std::memset(mask, 0, sizeof(float) * batch_cap * pos_length);

  int64_t total = 0;
  for (int64_t i = 0; i < batch; i++) {
    const int32_t u = bat_ids[i];
    // per-user RNG + fixed slot range (see determinism contract above)
    Rng rng(seed ^ (0x9e3779b97f4a7c15ULL * (uint64_t)(u + 1)));
    int64_t cur = i * (int64_t)samp_num;
    const int64_t s0 = seq_offsets[u], s1 = seq_offsets[u + 1];
    const int64_t full_len = s1 - s0;
    const int64_t pos_len = full_len - 1;  // posset = sequence[:-1]
    int64_t choose = 1;
    const int64_t samp = std::min<int64_t>(samp_num, std::max<int64_t>(pos_len, 0));
    if (samp > 0) {
      int64_t hi = std::min<int64_t>(pred_num + 1, pos_len - 3);
      if (hi < 1) hi = 1;
      choose = 1 + rng.bounded((uint32_t)hi);
      const int32_t pos_item = seq_items[s0 + pos_len - choose];
      const int32_t last_item = seq_items[s1 - 1];
      const int32_t test_item = tst_int[u];
      const int64_t r0 = trn_indptr[u], r1 = trn_indptr[u + 1];
      for (int64_t j = 0; j < samp; j++) {
        // rejection sample a negative
        int32_t neg;
        for (;;) {
          neg = (int32_t)rng.bounded((uint32_t)num_items);
          if (neg == last_item || neg == test_item) continue;
          if (row_contains(trn_indices, r0, r1, neg)) continue;
          break;
        }
        uids[cur] = u;
        useq_row[cur] = (int32_t)i;
        pos_iids[cur] = pos_item;
        neg_iids[cur] = neg;
        pair_mask[cur] = 1.0f;
        cur++;
        total++;
      }
    }
    // sequence row: posset[:-choose], right-aligned
    const int64_t keep = std::max<int64_t>(pos_len - choose, 0);
    fill_sequence(seq_items + s0, keep, pos_length, seq + i * pos_length,
                  mask + i * pos_length);
  }
  return total;
}

// SSL batch for one interval graph, COLUMN-SLICED. Outputs sized
// [col_size]; a full batch is col_start=0, col_size=batch_cap*ssl_num.
// Returns the number of real pairs in the requested window.
//
// Reference layout: interleaved (u,pos)(u,neg) draws flattened across the
// batch, then split at the global half — pair column j pairs flat entry j
// ("a" side) with flat entry half+j ("b" side) (model.py:186-196+328-338).
//
// Determinism contract (mirrors sample_train_batch): user u's draws come
// from Rng(mix(seed, u)) and land at flat positions fixed by the
// DETERMINISTIC per-user pair counts (n_u = min(ssl_num, deg/2), prefix
// sum over the batch) — no sequential RNG crosses users, so computing any
// column window reproduces exactly those columns of a full-batch call.
// Each host in a multi-process run samples only its own pair columns:
// host work is O(window users + 2 boundary users), not O(global batch).
int64_t sample_ssl_batch(
    uint64_t seed,
    const int32_t* bat_ids, int64_t batch,
    const int64_t* sub_indptr, const int32_t* sub_indices,  // interval CSR
    int32_t ssl_num,
    int64_t col_start, int64_t col_size,
    // outputs, each [col_size]
    int32_t* u_a, int32_t* i_a, int32_t* u_b, int32_t* i_b, float* m) {
  std::memset(u_a, 0, sizeof(int32_t) * col_size);
  std::memset(i_a, 0, sizeof(int32_t) * col_size);
  std::memset(u_b, 0, sizeof(int32_t) * col_size);
  std::memset(i_b, 0, sizeof(int32_t) * col_size);
  std::memset(m, 0, sizeof(float) * col_size);

  int64_t* prefix = new int64_t[batch + 1];
  prefix[0] = 0;
  for (int64_t i = 0; i < batch; i++) {
    const int32_t u = bat_ids[i];
    const int64_t deg = sub_indptr[u + 1] - sub_indptr[u];
    const int64_t n = std::min<int64_t>(ssl_num, deg / 2);
    prefix[i + 1] = prefix[i] + 2 * n;
  }
  const int64_t total = prefix[batch];
  const int64_t half = total / 2;
  const int64_t col_end = col_start + col_size;
  int32_t* dbuf = new int32_t[2 * (int64_t)ssl_num];

  // emit flat positions [lo, hi) into du/di at offset (pos - base)
  auto emit = [&](int64_t lo, int64_t hi, int64_t base, int32_t* du,
                  int32_t* di) {
    if (hi <= lo) return;
    int64_t i = std::upper_bound(prefix, prefix + batch + 1, lo)
        - prefix - 1;
    if (i < 0) i = 0;
    for (; i < batch && prefix[i] < hi; i++) {
      const int64_t p0 = prefix[i], c = prefix[i + 1] - p0;
      if (c == 0) continue;
      const int64_t s = std::max(lo, p0), e = std::min(hi, p0 + c);
      if (s >= e) continue;
      const int32_t u = bat_ids[i];
      Rng rng(seed ^ (0x9e3779b97f4a7c15ULL * (uint64_t)(u + 1)));
      const int64_t r0 = sub_indptr[u];
      const int64_t deg = sub_indptr[u + 1] - r0;
      const int64_t n = c / 2;
      // 2n sequential draws with replacement; interleave like the
      // reference: flat[2j] = draws[j], flat[2j+1] = draws[n+j]
      for (int64_t t = 0; t < c; t++)
        dbuf[t] = sub_indices[r0 + rng.bounded((uint32_t)deg)];
      for (int64_t p = s; p < e; p++) {
        const int64_t t = p - p0;
        du[p - base] = u;
        di[p - base] = (t % 2 == 0) ? dbuf[t / 2] : dbuf[n + t / 2];
      }
    }
  };
  emit(col_start, std::min(col_end, half), col_start, u_a, i_a);
  emit(half + col_start, std::min(half + col_end, total),
       half + col_start, u_b, i_b);
  const int64_t real = std::max<int64_t>(
      0, std::min(col_end, half) - col_start);
  for (int64_t j = 0; j < real; j++) m[j] = 1.0f;
  delete[] dbuf;
  delete[] prefix;
  return real;
}

}  // extern "C"
