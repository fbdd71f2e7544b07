// NNUE feature-transformer gather-accumulate for Hopper (sm_90a): one
// launch per call, one block per batch entry.
//
// Replaces: fishnet_tpu/ops/ft_gather.py:_kernel (the Pallas TPU kernel
// launched by _pallas_ft_accumulate, selected by ft_accumulate), and the
// XLA ops that surrounded it on the TPU: the wire expansion
// (jax_eval.expand_packed) and the anchor-table store
// (jax_eval._packed_anchored_core's scatter).
//
// What it computes, for every entry b and perspective p (see
// fishnet_tpu_torch/ops/ft_gather.py for the plain PyTorch version it is
// held against bit for bit):
//   acc[b,p,:]  = ft_b + sum_k ft_w[idx[b,p,k]]          (int16 -> int32)
//   psqt[b,p,:] =        sum_k ft_psqt[idx[b,p,k]]       (no bias)
// with the wire's parent codes (decode_parent): delta entries read only
// the 2*DELTA_SLOTS live slots, decode removals (idx >= delta_base
// subtracts row idx - delta_base) and carry no bias; persistent deltas
// add the perspective-swapped anchor_tab[aid] row (and psqt_tab[aid]);
// in-batch deltas add the perspective-swapped accumulator of the entry
// they reference. In packed mode the indices come straight from the
// compact wire (uint16 rows [R, 2, 8]: 4 rows per full entry, 1 per
// delta, at each entry's row offset, clamped into the stream) and every
// anchor entry's result is stored back to its anchor_tab / psqt_tab row
// in place; dense mode reads int32 [B, 2, 32] indices and leaves the
// tables alone.
//
// What bounds it on this card: latency, not bandwidth. A serving step
// moves a few MB (mostly one 2 KiB table row per live slot, from a
// 46 MB table that stays in the 50 MB L2 between steps) — about 2 us at
// HBM rate — and does 0.5 integer add per byte read. What costs time is
// the chain of dependent memory round trips each entry walks
// (chip_smoke.py --phases serve,anatomy times its parts). The design
// cuts the chain, not the bytes:
//   * one launch: delta resolution, wire decode and table store are in
//     the kernel, so nothing waits for a second launch to drain;
//   * one block per entry covering both perspectives (L1/4 threads, 8
//     int32 lanes and one 16 B row slice each): a persistent delta with
//     swap reads anchor_tab[aid][p ^ 1] while the same entry stores
//     anchor_tab[aid][p], so the block reads both rows before it stores
//     either (a __syncthreads between);
//   * the slot list is compacted once per perspective (warp ballot):
//     the zero sentinel row and unused delta slots are never fetched;
//     then up to 8 rows per thread are loaded before the first add, so
//     a delta entry's rows are all in flight at once (a full entry's
//     up to 32 rows take up to 4 such batches: 64 registers a thread
//     keep 4 blocks, the B=512 serving step, resident on each SM);
//   * entries are claimed in wire order through a ticket (atomicAdd on
//     a device counter), not by blockIdx: the pool's anchor protocol
//     makes every in-batch delta reference an EARLIER anchor entry, so
//     that anchor's block is already resident when the delta waits on
//     it. A delta sums its own rows first, then spins (one thread,
//     acquire) on the anchor's ready word and adds swap(acc[ref]) from
//     L2; the anchor publishes its word with release semantics after
//     storing acc and PSQT. Anchor entries never wait, so the waits
//     cannot deadlock. A reference the wire contract forbids (ref >= b,
//     or to an entry that is not an anchor) is counted and never
//     waited on, and a wait also gives up (counted) after a bounded
//     spin, so no input can hang the kernel;
//   * no memset launch and no second atomic: the ticket is one 64-bit
//     device word, the launch's epoch in its high half and the next
//     entry in its low half; the block that claims the last entry rolls
//     it over to (epoch + 1, 0). Ready words hold the epoch, so they
//     need no reset either. Because the epoch lives on the device, a
//     launch replayed from a CUDA graph gets a new one too. Calls that
//     share a device's state must be stream-ordered.
//
// Every decoded index is checked against the table's row count; an
// out-of-range index (or a malformed parent reference) is never read and
// is counted in the state's error word instead.
//
// Copy-source mode (packed mode with copy_src, int32 [batch]): the
// position-dedup fan-in of a fused dispatch, JAX's jnp.take(acc,
// copy_src) before the head and the table scatter
// (fishnet_tpu/nnue/jax_eval.py _packed_anchored_core). An entry b with
// copy_src[b] = s != b finishes with entry s's resolved accumulator and
// PSQT (same perspective, not swapped): in its output rows and, if it is
// a store entry, in its anchor_tab / psqt_tab row. The source precedes
// its duplicate in wire order (the planner maps each duplicate to its
// first occurrence), so its block has claimed its ticket first: the
// duplicate waits (acquire) on the source's ready word as an in-batch
// delta waits on its anchor, then reads acc[s] from L2 in place of its
// own result, before any store. In this mode every entry publishes its
// ready word, since a source may be a delta. A source that is out of
// range, not earlier, or itself redirected is counted and never waited
// on (the entry keeps its own result); the host checks the same contract
// before upload (ops/ft_gather.py check_copy_src).
//
// Partials mode (dense mode with sparse, int32 [batch], and no parent):
// the JAX kernel's `sparse=` mode (flags bit 0 without the anchor path).
// An entry with sparse[b] != 0 reads only its 2*DELTA_SLOTS live slots,
// decodes removals, and comes back as a bias-included PARTIAL, bias +
// adds - removes (PSQT: adds - removes); nothing resolves it, the caller
// does. The other entries are plain fulls. It is the delta
// accumulation with the resolve step skipped.
//
// Several cards: the wrapper launches under the tensors' device
// (torch.cuda.device), so a shard on cuda:N launches on cuda:N's stream
// whatever the calling thread's current device is.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSlots = 32;       // spec.MAX_ACTIVE_FEATURES
constexpr int kDeltaSlots = 4;   // spec.DELTA_SLOTS
constexpr int kWireRow = 8;      // slots per wire row and perspective
constexpr int kLanes = 8;        // int32 lanes per thread (one 16 B load)
constexpr int kPsqtBuckets = 8;  // spec.NUM_PSQT_BUCKETS
constexpr int kInFlight = 8;     // table rows loaded before the first add
constexpr int kSpinLimit = 1 << 24;

// Device state (int32 [4], zeroed once by the wrapper): words 0-1 the
// 64-bit ticket (low: next entry, high: epoch), word 3 the error count.
constexpr int kErrors = 3;

struct Args {
  const int16_t* ft_w;
  int n_rows, l1;
  const int16_t* ft_b;
  const int32_t* ft_psqt;     // NULL: no PSQT
  const int32_t* idx;         // dense mode [batch, 2, 32]
  const uint16_t* wire;       // packed mode [n_wire, 2, 8]
  int n_wire;
  const int32_t* offsets;     // packed mode [batch]
  const int32_t* parent;      // [batch] or NULL (every entry plain full)
  const int32_t* copy_src;    // packed mode [batch] or NULL (identity)
  const int32_t* sparse;      // dense mode [batch] or NULL: partials mode
  int32_t* anchor_tab;        // [n_anchor, 2, l1] or NULL
  int32_t* psqt_tab;          // [n_anchor, 2, 8] or NULL
  int n_anchor, delta_base, batch;
  int32_t* acc;               // [batch, 2, l1]
  int32_t* psqt;              // [batch, 2, 8] (with PSQT)
  int32_t* state;             // int32 [4], 16-byte aligned
  int32_t* ready;             // [>= batch]
};

struct Parent {
  bool in_batch, persistent, stores;
  int ref, swap, aid;
};

// Mirror of ops/ft_gather.py decode_parent: -1 plain full; >= 0 in-batch
// delta (ref << 1 | swap); <= -2 anchor-entry code -(2 + v) with
// v = (row << 2) | (is_delta << 1) | swap.
__device__ __forceinline__ Parent decode_parent(int code) {
  Parent d;
  const int v = -code - 2;
  d.stores = code <= -2;
  d.in_batch = code >= 0;
  d.persistent = d.stores && (v & 2);
  d.ref = d.in_batch ? (code >> 1) : 0;
  d.swap = d.in_batch ? (code & 1) : (d.stores ? (v & 1) : 0);
  d.aid = d.stores ? (v >> 2) : 0;
  return d;
}

__device__ __forceinline__ int ld_acquire(const int32_t* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int32_t* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ void add_row16(int32_t (&a)[kLanes], int4 v,
                                          int sign) {
  const int w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    // Little-endian: element 2i is the low half, 2i+1 the high half;
    // the casts and the arithmetic shift sign-extend both.
    a[2 * i] += sign * static_cast<int32_t>(static_cast<int16_t>(w[i]));
    a[2 * i + 1] += sign * (w[i] >> 16);
  }
}

// Rows written during this launch (anchor accumulators, table rows) are
// read through L2 (ld.cg), never the non-coherent path.
__device__ __forceinline__ void add_row32_l2(int32_t (&a)[kLanes],
                                             const int32_t* src) {
  const int4 lo = __ldcg(reinterpret_cast<const int4*>(src));
  const int4 hi = __ldcg(reinterpret_cast<const int4*>(src + 4));
  a[0] += lo.x; a[1] += lo.y; a[2] += lo.z; a[3] += lo.w;
  a[4] += hi.x; a[5] += hi.y; a[6] += hi.z; a[7] += hi.w;
}

__device__ __forceinline__ void store_row32(int32_t* dst,
                                            const int32_t (&a)[kLanes]) {
  *reinterpret_cast<int4*>(dst) = make_int4(a[0], a[1], a[2], a[3]);
  *reinterpret_cast<int4*>(dst + 4) = make_int4(a[4], a[5], a[6], a[7]);
}

// -- the kernel -------------------------------------------------------------

template <bool kPacked, bool kWithPsqt>
__global__ void __launch_bounds__(1024) ft_kernel(const Args a) {
  __shared__ int s_row[2][kSlots];
  __shared__ int s_sign[2][kSlots];
  __shared__ int s_live[2];
  __shared__ int s_b, s_epoch, s_follow, s_ready, s_copy;
  __shared__ int s_code, s_partial, s_slot[2][kSlots];

  const int tid = threadIdx.x;
  const int tpp = a.l1 / kLanes;  // threads per perspective
  const int p = tid >= tpp ? 1 : 0;
  const int pt = tid - p * tpp;
  const int lane0 = pt * kLanes;
  const bool psqt_lane = kWithPsqt && pt < kPsqtBuckets;
  int32_t* err = a.state + kErrors;

  if (tid == 0) {
    auto* ticket = reinterpret_cast<unsigned long long*>(a.state);
    const unsigned long long t = atomicAdd(ticket, 1ull);
    s_b = static_cast<int>(t & 0xffffffffu);
    // Epochs count from 1, so a zeroed ready word never matches one.
    s_epoch = static_cast<int>(t >> 32) + 1;
    if (s_b == a.batch - 1)  // the last claimant: (epoch + 1, 0)
      atomicAdd(ticket, (1ull << 32) - static_cast<unsigned>(a.batch));
  }
  __syncthreads();
  const int b = s_b;
  const int epoch = s_epoch;

  if (b < a.batch) {
    // The parent code and the slot indices load together: every slot a
    // full entry could own, masked below once the code is known.
    if (pt < kSlots) {
      if (tid == 0) {
        s_code = a.parent != nullptr ? __ldg(a.parent + b) : -1;
        s_partial = a.parent == nullptr && a.sparse != nullptr &&
                    __ldg(a.sparse + b) != 0;
      }
      if constexpr (kPacked) {
        int row = __ldg(a.offsets + b) + pt / kWireRow;
        row = min(max(row, 0), a.n_wire - 1);
        s_slot[p][pt] = __ldg(a.wire + (static_cast<int64_t>(row) * 2 + p) *
                                           kWireRow + pt % kWireRow);
      } else {
        s_slot[p][pt] =
            __ldg(a.idx + (static_cast<int64_t>(b) * 2 + p) * kSlots + pt);
      }
    }
    __syncthreads();
    const int code = s_code;
    const Parent d = decode_parent(code);
    // Deltas carry no bias (their anchor does); partials keep it.
    const bool resolves = d.in_batch || d.persistent;
    const bool sparse = resolves || s_partial;
    const int n_slots = sparse ? 2 * kDeltaSlots : kSlots;

    // Decode and compact each perspective's slot list in its first
    // warp: live slots (a real row, in range) move to the front.
    if (pt < kSlots) {
      int f = 0, sign = 0;
      if (pt < n_slots) {
        f = s_slot[p][pt];
        sign = 1;
        if (a.delta_base >= 0 && f >= a.delta_base) {
          f -= a.delta_base;
          sign = -1;
        }
        if (f < 0 || f >= a.n_rows) {
          atomicAdd(err, 1);  // never read an out-of-range row
          sign = 0;
        } else if (f == a.n_rows - 1) {
          sign = 0;  // the zero sentinel row: nothing to add
        }
      }
      const unsigned live = __ballot_sync(0xffffffffu, sign != 0);
      if (sign != 0) {
        const int pos = __popc(live & ((1u << pt) - 1u));
        s_row[p][pos] = f;
        s_sign[p][pos] = sign;
      }
      if (pt == 0) s_live[p] = __popc(live);
      if (tid == 0 && d.in_batch) {
        // The wire contract: an in-batch delta references an EARLIER
        // entry that is an anchor. Anything else is counted, never
        // waited on (a later entry's block may not be resident).
        const bool ok = d.ref < b && __ldg(a.parent + d.ref) < 0;
        if (!ok) atomicAdd(err, 1);
        s_follow = ok;
      }
    }
    __syncthreads();
    const int n_live = s_live[p];
    const bool follow = d.in_batch && s_follow;

    // The anchor-table row a persistent delta resolves against.
    bool use_tab = false;
    int64_t tab_row = 0;
    if (d.persistent) {
      if (a.anchor_tab == nullptr || d.aid >= a.n_anchor ||
          (kWithPsqt && a.psqt_tab == nullptr)) {
        if (tid == 0) atomicAdd(err, 1);
      } else {
        use_tab = true;
        tab_row = static_cast<int64_t>(d.aid) * 2 + (p ^ d.swap);
      }
    }

    int32_t acc[kLanes];
#pragma unroll
    for (int j = 0; j < kLanes; ++j) acc[j] = 0;
    int32_t ps = 0;
    if (use_tab) {
      add_row32_l2(acc, a.anchor_tab + tab_row * a.l1 + lane0);
      if (psqt_lane) ps += __ldcg(a.psqt_tab + tab_row * kPsqtBuckets + pt);
    }
    if (!resolves)
      add_row16(acc, __ldg(reinterpret_cast<const int4*>(a.ft_b + lane0)), 1);

    for (int k0 = 0; k0 < n_live; k0 += kInFlight) {
      int4 v[kInFlight];
      int32_t q[kInFlight];
#pragma unroll
      for (int j = 0; j < kInFlight; ++j) {
        if (k0 + j < n_live) {
          const int64_t r = s_row[p][k0 + j];
          v[j] = __ldg(reinterpret_cast<const int4*>(a.ft_w + r * a.l1 +
                                                     lane0));
          if (psqt_lane) q[j] = __ldg(a.ft_psqt + r * kPsqtBuckets + pt);
        }
      }
#pragma unroll
      for (int j = 0; j < kInFlight; ++j) {
        if (k0 + j < n_live) {
          const int sg = s_sign[p][k0 + j];
          add_row16(acc, v[j], sg);
          if (psqt_lane) ps += sg * q[j];
        }
      }
    }

    if (follow) {
      // In-batch delta: wait for the referenced anchor entry, then add
      // its perspective-swapped accumulator.
      if (tid == 0) {
        int spins = 0;
        while (ld_acquire(a.ready + d.ref) != epoch && spins < kSpinLimit)
          ++spins;
        s_ready = spins < kSpinLimit;
        if (!s_ready) atomicAdd(err, 1);
      }
      __syncthreads();
      if (s_ready) {
        const int64_t src = static_cast<int64_t>(d.ref) * 2 + (p ^ d.swap);
        add_row32_l2(acc, a.acc + src * a.l1 + lane0);
        if (psqt_lane) ps += __ldcg(a.psqt + src * kPsqtBuckets + pt);
      }
    }

    if (kPacked && a.copy_src != nullptr) {
      // Copy-source fan-in: wait for the source, then take its result.
      if (tid == 0) {
        const int src = __ldg(a.copy_src + b);
        int take = -1;
        if (src != b) {
          if (src < 0 || src >= b || __ldg(a.copy_src + src) != src) {
            atomicAdd(err, 1);  // never wait on a later or redirected one
          } else {
            int spins = 0;
            while (ld_acquire(a.ready + src) != epoch && spins < kSpinLimit)
              ++spins;
            if (spins < kSpinLimit) take = src;
            else atomicAdd(err, 1);
          }
        }
        s_copy = take;
      }
      __syncthreads();
      if (s_copy >= 0) {
        const int64_t src = static_cast<int64_t>(s_copy) * 2 + p;
        const int4 lo = __ldcg(reinterpret_cast<const int4*>(
            a.acc + src * a.l1 + lane0));
        const int4 hi = __ldcg(reinterpret_cast<const int4*>(
            a.acc + src * a.l1 + lane0 + 4));
        acc[0] = lo.x; acc[1] = lo.y; acc[2] = lo.z; acc[3] = lo.w;
        acc[4] = hi.x; acc[5] = hi.y; acc[6] = hi.z; acc[7] = hi.w;
        if (psqt_lane) ps = __ldcg(a.psqt + src * kPsqtBuckets + pt);
      }
    }

    const int64_t dst = static_cast<int64_t>(b) * 2 + p;
    store_row32(a.acc + dst * a.l1 + lane0, acc);
    if (psqt_lane) a.psqt[dst * kPsqtBuckets + pt] = ps;
    if (kPacked && d.stores && d.aid < a.n_anchor && a.anchor_tab != nullptr) {
      // Every thread has read its anchor row (p ^ swap) into registers
      // before any thread overwrites row p of the same entry.
      __syncthreads();
      const int64_t row = static_cast<int64_t>(d.aid) * 2 + p;
      store_row32(a.anchor_tab + row * a.l1 + lane0, acc);
      if (psqt_lane && a.psqt_tab != nullptr)
        a.psqt_tab[row * kPsqtBuckets + pt] = ps;
    }

    // Publish an anchor entry (the only kind a delta may reference), or
    // any entry in copy-source mode (a source may be a delta): every
    // thread's stores, then the ready word with release semantics.
    if ((a.parent != nullptr && code < 0) ||
        (kPacked && a.copy_src != nullptr)) {
      __syncthreads();
      if (tid == 0) st_release(a.ready + b, epoch);
    }
  } else if (tid == 0) {
    atomicAdd(err, 1);  // more tickets than entries: corrupt state
  }
}

template <bool kPacked, bool kWithPsqt>
void launch(const Args& a, cudaStream_t stream) {
  ft_kernel<kPacked, kWithPsqt><<<a.batch, a.l1 / 4, 0, stream>>>(a);
}

}  // namespace

// C entry point, bound with ctypes by fishnet_tpu_torch/ops/ft_gather.py.
// Shapes: ft_w [n_rows, l1] int16 (last row the zero sentinel); ft_b [l1]
// int16; ft_psqt [n_rows, 8] int32 or NULL (no PSQT output). Dense mode:
// idx [batch, 2, 32] int32 and wire NULL. Packed mode: wire [n_wire, 2,
// 8] uint16 and offsets [batch] int32, idx NULL; packed mode also
// writes anchor entries back to the tables. parent [batch] int32 or
// NULL (every entry full); copy_src [batch] int32 or NULL (packed mode
// only: the copy-source fan-in above); sparse [batch] int32 or NULL (dense
// mode without parent only: the partials mode above); anchor_tab
// [n_anchor, 2, l1] / psqt_tab
// [n_anchor, 2, 8] int32 or NULL; delta_base < 0 disables removal
// decoding. Outputs acc [batch,
// 2, l1] and psqt [batch, 2, 8] int32. state is the device's int32 [4]
// (64-bit ticket, unused, errors), zeroed before its first use;
// ready holds at least batch int32. l1 must be a multiple of 256 and at
// most 4096, every pointer 16-byte aligned (the wrapper checks).
// Launches once on `stream` without synchronising and returns
// cudaGetLastError().
extern "C" int fc_ft_gather(const void* ft_w, int n_rows, int l1,
                            const void* ft_b, const void* ft_psqt,
                            const void* idx, const void* wire, int n_wire,
                            const void* offsets, int batch,
                            const void* parent, const void* copy_src,
                            const void* sparse, void* anchor_tab,
                            void* psqt_tab, int n_anchor, int delta_base,
                            void* acc, void* psqt,
                            void* state, void* ready, void* stream) {
  if (batch > 0) {
    Args a;
    a.ft_w = static_cast<const int16_t*>(ft_w);
    a.n_rows = n_rows;
    a.l1 = l1;
    a.ft_b = static_cast<const int16_t*>(ft_b);
    a.ft_psqt = static_cast<const int32_t*>(ft_psqt);
    a.idx = static_cast<const int32_t*>(idx);
    a.wire = static_cast<const uint16_t*>(wire);
    a.n_wire = n_wire;
    a.offsets = static_cast<const int32_t*>(offsets);
    a.parent = static_cast<const int32_t*>(parent);
    a.copy_src = static_cast<const int32_t*>(copy_src);
    a.sparse = static_cast<const int32_t*>(sparse);
    a.anchor_tab = static_cast<int32_t*>(anchor_tab);
    a.psqt_tab = static_cast<int32_t*>(psqt_tab);
    a.n_anchor = n_anchor;
    a.delta_base = delta_base;
    a.batch = batch;
    a.acc = static_cast<int32_t*>(acc);
    a.psqt = static_cast<int32_t*>(psqt);
    a.state = static_cast<int32_t*>(state);
    a.ready = static_cast<int32_t*>(ready);
    const bool packed = wire != nullptr;
    const bool with_psqt = ft_psqt != nullptr;
    auto s = static_cast<cudaStream_t>(stream);
    if (packed && with_psqt) launch<true, true>(a, s);
    else if (packed) launch<true, false>(a, s);
    else if (with_psqt) launch<false, true>(a, s);
    else launch<false, false>(a, s);
  }
  return static_cast<int>(cudaGetLastError());
}
