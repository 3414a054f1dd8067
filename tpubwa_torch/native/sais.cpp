// SA-IS suffix array construction (linear time, induced sorting).
//
// Native host-side index-build helper for tpubwa (the TPU framework's
// equivalent of bwa-mem2's index builder, SURVEY.md §3.2 — written from
// scratch from the published SA-IS algorithm [Nong, Zhang, Chan 2009]).
//
// Contract: s[0..n-1] with values in [0, K), where s[n-1] == 0 is the unique
// sentinel (strictly smallest, appears exactly once). SA[0..n-1] receives the
// suffix array; SA[0] == n-1 (the sentinel suffix).
//
// Build: g++ -O3 -shared -fPIC -o libtpubwa.so sais.cpp

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

template <typename T>
void get_counts(const T* s, int64_t* cnt, int64_t n, int64_t K) {
  std::memset(cnt, 0, sizeof(int64_t) * K);
  for (int64_t i = 0; i < n; ++i) cnt[s[i]]++;
}

// bkt[c] = start (heads) or one-past-end (tails) of bucket c
void get_buckets(const int64_t* cnt, int64_t* bkt, int64_t K, bool tails) {
  int64_t sum = 0;
  for (int64_t c = 0; c < K; ++c) {
    sum += cnt[c];
    bkt[c] = tails ? sum : sum - cnt[c];
  }
}

template <typename T>
void induce_sa(const T* s, int64_t* SA, const std::vector<bool>& is_s,
               const int64_t* cnt, int64_t* bkt, int64_t n, int64_t K) {
  // Induce L-type from sorted LMS (or sorted LMS-prefix seeds already in SA).
  get_buckets(cnt, bkt, K, false);
  for (int64_t i = 0; i < n; ++i) {
    int64_t j = SA[i];
    if (j > 0 && !is_s[j - 1]) SA[bkt[s[j - 1]]++] = j - 1;
  }
  // Induce S-type.
  get_buckets(cnt, bkt, K, true);
  for (int64_t i = n - 1; i >= 0; --i) {
    int64_t j = SA[i];
    if (j > 0 && is_s[j - 1]) SA[--bkt[s[j - 1]]] = j - 1;
  }
}

template <typename T>
void sais_main(const T* s, int64_t* SA, int64_t n, int64_t K) {
  if (n == 1) { SA[0] = 0; return; }

  std::vector<bool> is_s(n);
  is_s[n - 1] = true;
  for (int64_t i = n - 2; i >= 0; --i)
    is_s[i] = (s[i] < s[i + 1]) || (s[i] == s[i + 1] && is_s[i + 1]);

  auto is_lms = [&](int64_t i) { return i > 0 && is_s[i] && !is_s[i - 1]; };

  std::vector<int64_t> cnt(K), bkt(K);
  get_counts(s, cnt.data(), n, K);

  // Step 1: sort LMS substrings by induced sorting.
  std::fill(SA, SA + n, int64_t(-1));
  get_buckets(cnt.data(), bkt.data(), K, true);
  for (int64_t i = n - 1; i > 0; --i)
    if (is_lms(i)) SA[--bkt[s[i]]] = i;
  induce_sa(s, SA, is_s, cnt.data(), bkt.data(), n, K);

  // Compact sorted LMS positions into SA[0..n_lms).
  int64_t n_lms = 0;
  for (int64_t i = 0; i < n; ++i)
    if (is_lms(SA[i])) SA[n_lms++] = SA[i];

  // Name LMS substrings (equal substrings get equal names).
  int64_t* name_buf = SA + n_lms;  // reuse upper part of SA
  std::fill(name_buf, SA + n, int64_t(-1));
  int64_t name = 0, prev = -1;
  for (int64_t i = 0; i < n_lms; ++i) {
    int64_t pos = SA[i];
    bool diff = false;
    if (prev < 0) {
      diff = true;
    } else {
      for (int64_t d = 0;; ++d) {
        if (s[pos + d] != s[prev + d] || is_s[pos + d] != is_s[prev + d]) {
          diff = true;
          break;
        }
        if (d > 0 && (is_lms(pos + d) || is_lms(prev + d))) {
          // reached the end of one LMS substring
          if (!(is_lms(pos + d) && is_lms(prev + d))) diff = true;
          break;
        }
      }
    }
    if (diff) { ++name; prev = pos; }
    name_buf[pos / 2] = name - 1;
  }

  // Build the reduced string s1 (names in LMS order of appearance).
  std::vector<int64_t> s1(n_lms), lms_pos(n_lms);
  {
    int64_t j = 0;
    for (int64_t i = 1; i < n; ++i)
      if (is_lms(i)) lms_pos[j++] = i;
    for (int64_t i = 0; i < n_lms; ++i) s1[i] = name_buf[lms_pos[i] / 2];
  }

  std::vector<int64_t> SA1(n_lms);
  if (name < n_lms) {
    sais_main<int64_t>(s1.data(), SA1.data(), n_lms, name);
  } else {
    for (int64_t i = 0; i < n_lms; ++i) SA1[s1[i]] = i;
  }

  // Step 3: place LMS in final sorted order, induce full SA.
  std::fill(SA, SA + n, int64_t(-1));
  get_buckets(cnt.data(), bkt.data(), K, true);
  for (int64_t i = n_lms - 1; i >= 0; --i) {
    int64_t j = lms_pos[SA1[i]];
    SA[--bkt[s[j]]] = j;
  }
  induce_sa(s, SA, is_s, cnt.data(), bkt.data(), n, K);
}

}  // namespace

extern "C" {

// s: uint8 values in [0, K), s[n-1] == 0 unique sentinel. Returns 0 on ok.
int sais_u8(const uint8_t* s, int64_t* sa, int64_t n, int64_t K) {
  if (n <= 0 || K <= 0) return -1;
  if (s[n - 1] != 0) return -2;
  sais_main<uint8_t>(s, sa, n, K);
  return 0;
}

// Derive BWT codes from SA in one pass (host-side index build helper).
// bwt[i] = s[sa[i]-1] for sa[i] > 0; the row with sa[i] == 0 is skipped and
// its index returned as *primary. bwt must have n-1 slots (sentinel removed).
int bwt_from_sa(const uint8_t* s, const int64_t* sa, int64_t n, uint8_t* bwt,
                int64_t* primary) {
  int64_t j = 0;
  *primary = -1;
  for (int64_t i = 0; i < n; ++i) {
    if (sa[i] == 0) {
      *primary = i;
    } else {
      bwt[j++] = s[sa[i] - 1];
    }
  }
  return *primary < 0 ? -1 : 0;
}

}  // extern "C"
