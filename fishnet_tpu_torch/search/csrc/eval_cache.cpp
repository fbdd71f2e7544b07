// The tables behind fishnet_tpu_torch/search/eval_cache.py: a striped
// hash -> (values, generation) map with generation-based eviction, the
// JAX package's EvalCache / BoundsCache semantics entry for entry
// (fishnet_tpu/search/eval_cache.py), in native code so that a block
// probe or insert of a microbatch runs without the interpreter lock.
//
// A table holds W int64 value columns per entry (1: an eval; 6: a
// bound record). Each hash falls into one of `stripes` stripes (the
// high bits mixed in, as in Python); a stripe holds at most `cap`
// entries, and inserting a new key into a full stripe first drops its
// oldest generation(s) until it has room. One mutex per table guards
// everything, counters included; every call takes it once. Generations
// are below INT64_MAX (the free-slot mark).
//
// Built by the port with g++ (eval_cache.py), plain C interface.

#include <algorithm>
#include <array>
#include <climits>
#include <cstdint>
#include <mutex>
#include <vector>

namespace {

struct TableBase {
  virtual ~TableBase() = default;
};

// One stripe: its entries in slots of flat arrays (a freed slot has
// generation kFree and waits on the free list), and an open-addressing
// index from key to slot (linear probing, backward-shift deletion),
// both grown on demand up to the stripe's cap.
constexpr int64_t kFree = INT64_MAX;

template <int W>
struct Stripe {
  std::vector<uint64_t> keys;
  std::vector<int64_t> gens;
  std::vector<int64_t> vals;  // W per slot
  std::vector<int32_t> free_slots;
  std::vector<int32_t> index;  // slot + 1; 0 = empty
  int shift = 64;
  int64_t count = 0;

  size_t home(uint64_t h) const {
    return size_t((h * 0x9E3779B97F4A7C15ull) >> shift);
  }
  size_t mask() const { return index.size() - 1; }

  int32_t find(uint64_t h) const {
    if (index.empty()) return -1;
    for (size_t p = home(h);; p = (p + 1) & mask()) {
      int32_t s = index[p];
      if (s == 0) return -1;
      if (keys[s - 1] == h) return s - 1;
    }
  }

  void index_insert(uint64_t h, int32_t slot) {
    size_t p = home(h);
    while (index[p] != 0) p = (p + 1) & mask();
    index[p] = slot + 1;
  }

  void index_erase(uint64_t h) {
    size_t i = home(h);
    while (keys[index[i] - 1] != h) i = (i + 1) & mask();
    for (size_t j = (i + 1) & mask(); index[j] != 0; j = (j + 1) & mask()) {
      size_t k = home(keys[index[j] - 1]);
      bool stays = i <= j ? (i < k && k <= j) : (i < k || k <= j);
      if (!stays) {
        index[i] = index[j];
        i = j;
      }
    }
    index[i] = 0;
  }

  // Keeps the index at most half full for `want` entries.
  void reserve(int64_t want) {
    size_t size = index.empty() ? 16 : index.size();
    while (size < size_t(2 * want)) size *= 2;
    if (size == index.size()) return;
    index.assign(size, 0);
    shift = 64 - __builtin_ctzll(size);
    for (size_t s = 0; s < gens.size(); s++) {
      if (gens[s] != kFree) index_insert(keys[s], int32_t(s));
    }
  }
};

template <int W>
struct Table : TableBase {
  int64_t cap;
  std::vector<Stripe<W>> stripes;
  std::mutex mu;
  int64_t generation = 0, hits = 0, misses = 0, insertions = 0,
          evictions = 0, entries = 0;

  Table(int64_t capacity, int n_stripes) : stripes(n_stripes) {
    cap = std::max<int64_t>(1, (capacity + n_stripes - 1) / n_stripes);
  }

  Stripe<W>& stripe_of(uint64_t h) {
    return stripes[((h >> 48) ^ h) % stripes.size()];
  }

  void evict(Stripe<W>& st) {
    while (st.count >= cap && st.count > 0) {
      int64_t oldest = *std::min_element(st.gens.begin(), st.gens.end());
      for (size_t s = 0; s < st.gens.size(); s++) {
        if (st.gens[s] != oldest) continue;
        st.index_erase(st.keys[s]);
        st.gens[s] = kFree;
        st.free_slots.push_back(int32_t(s));
        st.count--;
        entries--;
        evictions++;
      }
    }
  }

  // The slot of `h` in `st`, created (after eviction, if the stripe is
  // full) when absent; its generation set to `gen`.
  int32_t place(Stripe<W>& st, uint64_t h, int64_t gen) {
    int32_t s = st.find(h);
    if (s < 0) {
      if (st.count >= cap) evict(st);
      if (st.free_slots.empty()) {
        s = int32_t(st.gens.size());
        st.keys.push_back(h);
        st.gens.push_back(kFree);  // set below, once indexed
        st.vals.resize(st.vals.size() + W);
      } else {
        s = st.free_slots.back();
        st.free_slots.pop_back();
        st.keys[s] = h;
      }
      st.reserve(st.count + 1);
      st.index_insert(h, s);
      st.count++;
      entries++;
    }
    st.gens[s] = gen;
    return s;
  }

  int64_t* row(Stripe<W>& st, int32_t s) { return st.vals.data() + int64_t(s) * W; }

  int probe(const uint64_t* keys, int n, int64_t* vals, uint8_t* hit) {
    int found = 0;
    for (int i = 0; i < n; i++) {
      Stripe<W>& st = stripe_of(keys[i]);
      int32_t s = st.find(keys[i]);
      hit[i] = s >= 0;
      if (s < 0) continue;
      st.gens[s] = generation;  // a hit is hot: it outlives its peers
      std::copy(row(st, s), row(st, s) + W, vals + int64_t(i) * W);
      found++;
    }
    hits += found;
    misses += n - found;
    return found;
  }

  void insert(const uint64_t* keys, const int64_t* vals, const int64_t* gens,
              int n) {
    for (int i = 0; i < n; i++) {
      Stripe<W>& st = stripe_of(keys[i]);
      int32_t s = place(st, keys[i], gens ? gens[i] : generation);
      std::copy(vals + int64_t(i) * W, vals + int64_t(i + 1) * W, row(st, s));
    }
  }

  // Deeper-entry-wins (bound records: column 2 the depth, 3 the bound
  // type, 1-3, 3 = exact). Returns 1 when the record landed.
  int insert_deeper(uint64_t key, const int64_t* vals) {
    if (vals[3] < 1 || vals[3] > 3) return 0;
    Stripe<W>& st = stripe_of(key);
    int32_t s = st.find(key);
    if (s >= 0) {
      const int64_t* old = row(st, s);
      if (old[2] > vals[2] ||
          (old[2] == vals[2] && old[3] == 3 && vals[3] != 3)) {
        st.gens[s] = generation;  // the survivor just proved it is hot
        return 0;
      }
    }
    s = place(st, key, generation);
    std::copy(vals, vals + W, row(st, s));
    insertions++;
    return 1;
  }

  int64_t dump(uint64_t* keys, int64_t* vals, int64_t* gens, int64_t room) {
    int64_t k = 0;
    for (auto& st : stripes) {
      for (size_t s = 0; s < st.gens.size(); s++) {
        if (st.gens[s] == kFree) continue;
        if (k >= room) return k;
        keys[k] = st.keys[s];
        gens[k] = st.gens[s];
        std::copy(row(st, int32_t(s)), row(st, int32_t(s)) + W, vals + k * W);
        k++;
      }
    }
    return k;
  }

  void clear() {
    for (auto& st : stripes) st = Stripe<W>();
    entries = 0;
  }
};

struct Handle {
  int width;
  TableBase* table;
};

// Runs `fn(table)` on the handle's table, typed by its width, under the
// table's mutex.
template <typename Fn>
auto with_table(void* handle, Fn fn) {
  Handle* h = static_cast<Handle*>(handle);
  if (h->width == 1) {
    auto* t = static_cast<Table<1>*>(h->table);
    std::lock_guard<std::mutex> g(t->mu);
    return fn(*t);
  }
  auto* t = static_cast<Table<6>*>(h->table);
  std::lock_guard<std::mutex> g(t->mu);
  return fn(*t);
}

}  // namespace

extern "C" {

// width 1 (evals) or 6 (bound records); nullptr for another width.
void* ect_new(int64_t capacity, int stripes, int width) {
  if (capacity < 1 || stripes < 1) return nullptr;
  if (width == 1) return new Handle{1, new Table<1>(capacity, stripes)};
  if (width == 6) return new Handle{6, new Table<6>(capacity, stripes)};
  return nullptr;
}

void ect_free(void* handle) {
  Handle* h = static_cast<Handle*>(handle);
  delete h->table;
  delete h;
}

// Probe n keys: a hit writes its W values at vals[i * W] and sets
// hit[i]; it is refreshed to the current generation. Returns the hits.
int ect_probe(void* handle, const uint64_t* keys, int n, int64_t* vals,
              uint8_t* hit) {
  return with_table(handle, [&](auto& t) { return t.probe(keys, n, vals, hit); });
}

// Store n entries in order, as n single inserts would (a repeated key
// keeps its last values). `gens` null: the current generation. With
// `count`, the entries count as insertions.
void ect_insert(void* handle, const uint64_t* keys, const int64_t* vals,
                const int64_t* gens, int n, int count) {
  with_table(handle, [&](auto& t) {
    t.insert(keys, vals, gens, n);
    if (count) t.insertions += n;
    return 0;
  });
}

// Deeper-entry-wins inserts of n bound records, in order; returns how
// many landed.
int ect_insert_deeper(void* handle, const uint64_t* keys,
                      const int64_t* vals, int n) {
  return with_table(handle, [&](auto& t) {
    int landed = 0;
    for (int i = 0; i < n; i++) {
      landed += t.insert_deeper(keys[i], vals + int64_t(i) * 6);
    }
    return landed;
  });
}

// Ticks the generation; with `at_least` >= 0 raises it to at least
// that instead. Returns the generation.
int64_t ect_generation(void* handle, int64_t at_least) {
  return with_table(handle, [&](auto& t) {
    if (at_least < 0) {
      t.generation++;
    } else {
      t.generation = std::max(t.generation, at_least);
    }
    return t.generation;
  });
}

// hits, misses, insertions, evictions, generation, entries.
void ect_stats(void* handle, int64_t* out) {
  with_table(handle, [&](auto& t) {
    int64_t s[6] = {t.hits, t.misses, t.insertions, t.evictions,
                    t.generation, t.entries};
    std::copy(s, s + 6, out);
    return 0;
  });
}

// Drops every entry; counters and generation stay.
void ect_clear(void* handle) {
  with_table(handle, [&](auto& t) {
    t.clear();
    return 0;
  });
}

// Writes up to `room` entries, stripe by stripe; returns how many.
int64_t ect_dump(void* handle, uint64_t* keys, int64_t* vals, int64_t* gens,
                 int64_t room) {
  return with_table(handle, [&](auto& t) { return t.dump(keys, vals, gens, room); });
}

}  // extern "C"
