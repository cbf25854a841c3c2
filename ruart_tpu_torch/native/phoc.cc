// PHOC (Pyramidal Histogram Of Characters) encoder - native host kernel.
//
// A from-scratch C++ implementation with the same feature contract as the
// reference's CPython extension (Utils/cphoc.c:12-113): 604-dim binary vector
// = 36 unigrams x 14 pyramid regions (levels 2..5) + 50 bigrams x 2 regions,
// with a region counted when >= 0.5 of the character span overlaps it, all in
// IEEE float32 arithmetic (bit-faithful boundary behavior).
//
// Exposed as a plain C ABI consumed via ctypes (no Python.h dependency), with
// a batch entry point so whole OCR candidate lists encode in one call.

#include <cstdint>
#include <cstring>

namespace {

constexpr int kUnigrams = 36;
constexpr int kBigrams = 50;
constexpr int kUnigramDims = 36 * 14;  // 504
constexpr int kPhocDim = 604;

// index 0..25 = 'a'..'z', 26..35 = '0'..'9', -1 otherwise
inline int unigram_index(char c) {
  if (c >= 'a' && c <= 'z') return c - 'a';
  if (c >= '0' && c <= '9') return 26 + (c - '0');
  return -1;
}

const char* kBigramTable[kBigrams] = {
    "th", "he", "in", "er", "an", "re", "es", "on", "st", "nt",
    "en", "at", "ed", "nd", "to", "or", "ea", "ti", "ar", "te",
    "ng", "al", "it", "as", "is", "ha", "et", "se", "ou", "of",
    "le", "sa", "ve", "ro", "ra", "ri", "hi", "ne", "me", "de",
    "co", "ta", "ec", "si", "ll", "so", "na", "li", "la", "el"};

inline int bigram_index(const char* s) {
  for (int k = 0; k < kBigrams; ++k) {
    if (s[0] == kBigramTable[k][0] && s[1] == kBigramTable[k][1]) return k;
  }
  return -1;
}

// Row offset of (level, region) in the 14-row unigram pyramid:
// level 2 -> rows 0..1, level 3 -> 2..4, level 4 -> 5..8, level 5 -> 9..13.
inline int level_offset(int level) {
  int sum = 0;
  for (int l = 2; l < 6; ++l)
    if (l < level) sum += l;
  return sum;
}

}  // namespace

extern "C" {

// Encode one already-filtered string (only [a-z0-9]) into out[604].
// Returns 0 on success, -1 if an unknown character is found.
int ruart_phoc(const char* word, int n, float* out) {
  std::memset(out, 0, kPhocDim * sizeof(float));
  for (int index = 0; index < n; ++index) {
    const float char_occ0 = static_cast<float>(index) / static_cast<float>(n);
    const float char_occ1 =
        static_cast<float>(index + 1) / static_cast<float>(n);
    const int char_index = unigram_index(word[index]);
    if (char_index == -1) return -1;
    for (int level = 2; level < 6; ++level) {
      for (int region = 0; region < level; ++region) {
        const float region_occ0 = static_cast<float>(region) / level;
        const float region_occ1 = static_cast<float>(region + 1) / level;
        const float overlap0 = char_occ0 > region_occ0 ? char_occ0 : region_occ0;
        const float overlap1 = char_occ1 < region_occ1 ? char_occ1 : region_occ1;
        const float frac = (overlap1 - overlap0) / (char_occ1 - char_occ0);
        if (frac >= 0.5f) {
          out[level_offset(level) * kUnigrams + region * kUnigrams +
              char_index] = 1.0f;
        }
      }
    }
  }
  // bigrams: level-2 pyramid only
  for (int i = 0; i < n - 1; ++i) {
    const int ngram_index = bigram_index(word + i);
    if (ngram_index == -1) continue;
    const float occ0 = static_cast<float>(i) / n;
    const float occ1 = static_cast<float>(i + 2) / n;
    for (int region = 0; region < 2; ++region) {
      const float region_occ0 = static_cast<float>(region) / 2;
      const float region_occ1 = static_cast<float>(region + 1) / 2;
      const float overlap0 = occ0 > region_occ0 ? occ0 : region_occ0;
      const float overlap1 = occ1 < region_occ1 ? occ1 : region_occ1;
      if ((overlap1 - overlap0) / (occ1 - occ0) >= 0.5f) {
        out[kUnigramDims + region * kBigrams + ngram_index] = 1.0f;
      }
    }
  }
  return 0;
}

// Batch encode: `buf` holds n concatenated strings; string i spans
// buf[offsets[i] .. offsets[i+1]) (offsets has n+1 entries). Output is a
// dense [n, 604] float32 row-major buffer. Unknown characters are skipped
// per-string (callers pre-filter; this keeps the batch path total).
int ruart_phoc_batch(const char* buf, const int64_t* offsets, int64_t n,
                     float* out) {
  for (int64_t i = 0; i < n; ++i) {
    const char* w = buf + offsets[i];
    const int len = static_cast<int>(offsets[i + 1] - offsets[i]);
    ruart_phoc(w, len, out + i * kPhocDim);
  }
  return 0;
}

int ruart_phoc_dim() { return kPhocDim; }

}  // extern "C"
