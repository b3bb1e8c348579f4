// fastset: open-addressing int64 hash set with insertion-order values.
//
// Native state->index directory of the compressed state set
// (pacmensl_tpu_torch/statespace/state_set.py), a copy of the reference
// package's pacmensl_tpu/native/fastset.cpp: the single-address-space
// replacement for the reference's Zoltan
// distributed directory (a rendezvous-hashed parallel hash table keyed by
// the state vector; reference src/StateSet/StateSetBase.cpp:630,
// Zoltan_DD_Create/Update/Find at :209-234, :330).  States are keyed by
// their mixed-radix linearization (reference src/Sys/pacmenMath.h:33-55);
// the stored value is the key's insertion rank, which by construction is
// the state's global index in the insertion-ordered state list.
//
// Exposed as a C ABI for ctypes: every entry point is a plain C call.
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int64_t EMPTY = INT64_MIN;

struct FastSet {
  std::vector<int64_t> keys;  // EMPTY marks a free slot
  std::vector<int64_t> vals;  // insertion rank of the key in that slot
  uint64_t mask = 0;          // capacity - 1 (capacity is a power of two)
  int64_t count = 0;
};

inline uint64_t hash64(uint64_t x) {
  // splitmix64 finalizer: avalanching, cheap, good for linear probing
  x ^= x >> 33;
  x *= 0xff51afd7ed558ccdULL;
  x ^= x >> 33;
  x *= 0xc4ceb9fe1a85ec53ULL;
  x ^= x >> 33;
  return x;
}

void rehash(FastSet* s, uint64_t new_capacity) {
  std::vector<int64_t> old_keys = std::move(s->keys);
  std::vector<int64_t> old_vals = std::move(s->vals);
  s->keys.assign(new_capacity, EMPTY);
  s->vals.assign(new_capacity, 0);
  s->mask = new_capacity - 1;
  for (size_t i = 0; i < old_keys.size(); ++i) {
    if (old_keys[i] == EMPTY) continue;
    uint64_t slot = hash64(static_cast<uint64_t>(old_keys[i])) & s->mask;
    while (s->keys[slot] != EMPTY) slot = (slot + 1) & s->mask;
    s->keys[slot] = old_keys[i];
    s->vals[slot] = old_vals[i];
  }
}

inline void maybe_grow(FastSet* s, int64_t incoming) {
  // keep load factor under ~0.7 for the worst case where every incoming
  // key is new
  uint64_t needed = static_cast<uint64_t>(s->count + incoming);
  uint64_t cap = s->mask + 1;
  while (needed * 10 >= cap * 7) cap <<= 1;
  if (cap != s->mask + 1) rehash(s, cap);
}

}  // namespace

extern "C" {

void* fastset_create(int64_t capacity_hint) {
  uint64_t cap = 64;
  while (static_cast<int64_t>(cap) * 7 < capacity_hint * 10) cap <<= 1;
  FastSet* s = new FastSet();
  s->keys.assign(cap, EMPTY);
  s->vals.assign(cap, 0);
  s->mask = cap - 1;
  return s;
}

void fastset_destroy(void* h) { delete static_cast<FastSet*>(h); }

int64_t fastset_size(void* h) { return static_cast<FastSet*>(h)->count; }

// Insert a batch of keys.  out_new[i] = 1 iff keys[i] was not present
// before this call (first occurrence within the batch wins).  Negative
// keys (the invalid-state codes of sub2ind) are never inserted.
// Returns the number of keys added.
int64_t fastset_insert(void* h, const int64_t* ks, int64_t n,
                       uint8_t* out_new) {
  FastSet* s = static_cast<FastSet*>(h);
  maybe_grow(s, n);
  int64_t added = 0;
  for (int64_t i = 0; i < n; ++i) {
    const int64_t k = ks[i];
    if (k < 0) {
      out_new[i] = 0;
      continue;
    }
    uint64_t slot = hash64(static_cast<uint64_t>(k)) & s->mask;
    while (true) {
      const int64_t cur = s->keys[slot];
      if (cur == k) {
        out_new[i] = 0;
        break;
      }
      if (cur == EMPTY) {
        s->keys[slot] = k;
        s->vals[slot] = s->count++;
        out_new[i] = 1;
        ++added;
        break;
      }
      slot = (slot + 1) & s->mask;
    }
  }
  return added;
}

// Batch lookup: out[i] = insertion rank of keys[i], or -1 if absent
// (including all negative/invalid keys) — the reference State2Index
// contract (src/StateSet/StateSetBase.cpp:309-343).
void fastset_lookup(void* h, const int64_t* ks, int64_t n, int64_t* out) {
  const FastSet* s = static_cast<const FastSet*>(h);
  for (int64_t i = 0; i < n; ++i) {
    const int64_t k = ks[i];
    if (k < 0) {
      out[i] = -1;
      continue;
    }
    uint64_t slot = hash64(static_cast<uint64_t>(k)) & s->mask;
    while (true) {
      const int64_t cur = s->keys[slot];
      if (cur == k) {
        out[i] = s->vals[slot];
        break;
      }
      if (cur == EMPTY) {
        out[i] = -1;
        break;
      }
      slot = (slot + 1) & s->mask;
    }
  }
}

// Mixed-radix linearization of a batch of states (row-major [n, dim],
// first coordinate fastest), matching pacmensl_tpu_torch.sys.indexing.sub2ind /
// reference pacmenMath.h:33-55: negative coordinate -> -1, coordinate i
// over nmax[i] -> -(i+2).
void fastset_sub2ind(const int64_t* nmax, int64_t dim, const int64_t* states,
                     int64_t n, int64_t* out) {
  std::vector<int64_t> stride(dim);
  int64_t acc = 1;
  for (int64_t d = 0; d < dim; ++d) {
    stride[d] = acc;
    acc *= nmax[d] + 1;
  }
  for (int64_t i = 0; i < n; ++i) {
    const int64_t* x = states + i * dim;
    int64_t key = 0;
    int64_t first_over = -1;  // first coordinate exceeding its max
    bool any_neg = false;
    for (int64_t d = 0; d < dim; ++d) {
      const int64_t v = x[d];
      any_neg |= (v < 0);
      if (v > nmax[d] && first_over < 0) first_over = d;
      key += v * stride[d];
    }
    // precedence matches sys.indexing.sub2ind / pacmenMath.h:41-55:
    // a negative coordinate anywhere wins over an over-range code
    if (any_neg)
      key = -1;
    else if (first_over >= 0)
      key = -(first_over + 2);
    out[i] = key;
  }
}

}  // extern "C"
