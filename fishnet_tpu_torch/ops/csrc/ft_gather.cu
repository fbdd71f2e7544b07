// NNUE feature-transformer gather-accumulate for Hopper (sm_90a).
//
// Replaces: fishnet_tpu/ops/ft_gather.py:_kernel (the Pallas TPU kernel
// launched by _pallas_ft_accumulate, selected by ft_accumulate).
//
// What it computes, for every entry b and perspective p (see
// fishnet_tpu_torch/ops/ft_gather.py for the plain PyTorch version it is
// held against bit for bit):
//   acc[b,p,:]  = ft_b + sum_k ft_w[idx[b,p,k]]          (int16 -> int32)
//   psqt[b,p,:] =        sum_k ft_psqt[idx[b,p,k]]       (no bias)
// with the wire's parent codes (decode_parent): sparse (delta) entries
// read only the 2*DELTA_SLOTS live slots, decode removals
// (idx >= delta_base subtracts row idx - delta_base) and carry no bias;
// persistent deltas add the perspective-swapped anchor_tab[aid] row
// (and psqt_tab[aid]); in-batch deltas add the perspective-swapped
// accumulator of the entry they reference.
//
// What bounds it on this card: bytes read from HBM. Each live slot pulls
// one 2 KiB int16 row of the 46 MB table at a data-dependent address and
// does 1024 integer adds with it (0.5 add per byte), far below the
// ~300 operations per byte where the H100's compute would become the
// limit. The design therefore only spends effort on the row traffic:
//   * one block per (entry, perspective), 128 threads, each owning 8 of
//     the 1024 int32 lanes and reading its 16 B slice of a row with one
//     vector load, so a warp reads 512 contiguous bytes per row;
//   * the slot list is compacted once per block (warp ballot): the zero
//     sentinel row and unused delta slots are never fetched, so a full
//     entry reads only its ~26 real rows and a delta entry its few;
//   * no intermediate [B, 2, 32, L1] gather lands in HBM (the plain
//     version's cost): rows are reduced in registers.
// CUDA blocks run in no order, so the TPU kernel's running in-VMEM
// anchor (carried across grid steps and 512-entry chunks) has no
// counterpart: in-batch deltas resolve by their explicit reference in a
// second launch, after the first has finished every anchor entry.
//
// Every decoded index is checked against the table's row count; an
// out-of-range index (or a malformed parent reference) is never read and
// is counted in the device-side error word `err` instead.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSlots = 32;       // spec.MAX_ACTIVE_FEATURES
constexpr int kDeltaSlots = 4;   // spec.DELTA_SLOTS
constexpr int kLanes = 8;        // int32 lanes per thread (one 16 B load)
constexpr int kPsqtBuckets = 8;  // spec.NUM_PSQT_BUCKETS

struct Parent {
  bool in_batch, persistent;
  int ref, swap, aid;
};

// Mirror of ops/ft_gather.py decode_parent: -1 plain full; >= 0 in-batch
// delta (ref << 1 | swap); <= -2 anchor-entry code -(2 + v) with
// v = (row << 2) | (is_delta << 1) | swap.
__device__ __forceinline__ Parent decode_parent(int code) {
  Parent d;
  const int v = -code - 2;
  const bool stores = code <= -2;
  d.in_batch = code >= 0;
  d.persistent = stores && (v & 2);
  d.ref = d.in_batch ? (code >> 1) : 0;
  d.swap = d.in_batch ? (code & 1) : (stores ? (v & 1) : 0);
  d.aid = stores ? (v >> 2) : 0;
  return d;
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

__device__ __forceinline__ void add_row32(int32_t (&a)[kLanes],
                                          const int32_t* src) {
  const int4 lo = *reinterpret_cast<const int4*>(src);
  const int4 hi = *reinterpret_cast<const int4*>(src + 4);
  a[0] += lo.x; a[1] += lo.y; a[2] += lo.z; a[3] += lo.w;
  a[4] += hi.x; a[5] += hi.y; a[6] += hi.z; a[7] += hi.w;
}

__device__ __forceinline__ void store_row32(int32_t* dst,
                                            const int32_t (&a)[kLanes]) {
  *reinterpret_cast<int4*>(dst) = make_int4(a[0], a[1], a[2], a[3]);
  *reinterpret_cast<int4*>(dst + 4) = make_int4(a[4], a[5], a[6], a[7]);
}

// Launch 1: gather, removal decode, bias and persistent-anchor resolve.
// Grid: one block per (entry, perspective); blockDim.x * kLanes == l1.
template <bool kWithPsqt>
__global__ void ft_gather_kernel(
    const int16_t* __restrict__ ft_w, int n_rows, int l1,
    const int16_t* __restrict__ ft_b,
    const int32_t* __restrict__ ft_psqt,
    const int32_t* __restrict__ idx,
    const int32_t* __restrict__ parent,
    const int32_t* __restrict__ anchor_tab,
    const int32_t* __restrict__ psqt_tab, int n_anchor,
    int delta_base,
    int32_t* __restrict__ acc, int32_t* __restrict__ psqt,
    int32_t* __restrict__ err) {
  __shared__ int s_row[kSlots];
  __shared__ int s_sign[kSlots];
  __shared__ int s_live;

  const int b = blockIdx.x >> 1;
  const int p = blockIdx.x & 1;
  const int tid = threadIdx.x;
  const Parent d = decode_parent(parent != nullptr ? parent[b] : -1);
  const bool sparse = d.in_batch || d.persistent;
  const int n_slots = sparse ? 2 * kDeltaSlots : kSlots;

  // Decode and compact the slot list in warp 0: live slots (a real row,
  // in range) move to the front, so the row loop below has no holes.
  if (tid < kSlots) {
    int f = 0, sign = 0;
    if (tid < n_slots) {
      f = idx[(static_cast<int64_t>(b) * 2 + p) * kSlots + tid];
      sign = 1;
      if (delta_base >= 0 && f >= delta_base) {
        f -= delta_base;
        sign = -1;
      }
      if (f < 0 || f >= n_rows) {
        atomicAdd(err, 1);  // never read an out-of-range row
        sign = 0;
      } else if (f == n_rows - 1) {
        sign = 0;  // the zero sentinel row: nothing to add
      }
    }
    const unsigned live = __ballot_sync(0xffffffffu, sign != 0);
    if (sign != 0) {
      const int pos = __popc(live & ((1u << tid) - 1u));
      s_row[pos] = f;
      s_sign[pos] = sign;
    }
    if (tid == 0) s_live = __popc(live);
  }
  __syncthreads();
  const int n_live = s_live;

  // The anchor-table row this entry resolves against (persistent deltas).
  bool use_tab = false;
  int64_t tab_row = 0;
  if (d.persistent) {
    if (anchor_tab == nullptr || d.aid >= n_anchor ||
        (kWithPsqt && psqt_tab == nullptr)) {
      if (tid == 0) atomicAdd(err, 1);
    } else {
      use_tab = true;
      tab_row = static_cast<int64_t>(d.aid) * 2 + (p ^ d.swap);
    }
  }

  const int lane0 = tid * kLanes;
  int32_t a[kLanes];
  if (sparse) {
#pragma unroll
    for (int j = 0; j < kLanes; ++j) a[j] = 0;
  } else {
    const int4 bias = *reinterpret_cast<const int4*>(ft_b + lane0);
#pragma unroll
    for (int j = 0; j < kLanes; ++j) a[j] = 0;
    add_row16(a, bias, 1);
  }
#pragma unroll 4
  for (int k = 0; k < n_live; ++k) {
    const int4 v = __ldg(reinterpret_cast<const int4*>(
        ft_w + static_cast<int64_t>(s_row[k]) * l1 + lane0));
    add_row16(a, v, s_sign[k]);
  }
  if (use_tab) add_row32(a, anchor_tab + tab_row * l1 + lane0);
  store_row32(acc + (static_cast<int64_t>(b) * 2 + p) * l1 + lane0, a);

  if (kWithPsqt && tid < kPsqtBuckets) {
    int32_t s = 0;
    for (int k = 0; k < n_live; ++k)
      s += s_sign[k] *
           __ldg(ft_psqt + static_cast<int64_t>(s_row[k]) * kPsqtBuckets + tid);
    if (use_tab) s += psqt_tab[tab_row * kPsqtBuckets + tid];
    psqt[(static_cast<int64_t>(b) * 2 + p) * kPsqtBuckets + tid] = s;
  }
}

// Launch 2: in-batch deltas add the perspective-swapped result of the
// entry they reference. That entry is an anchor entry (full or
// persistent), which launch 1 finished and this launch never writes, so
// reads and writes cannot race; a reference to a non-anchor entry or
// past the batch breaks the wire contract and is counted, not followed.
template <bool kWithPsqt>
__global__ void ft_resolve_kernel(const int32_t* __restrict__ parent,
                                  int batch, int l1,
                                  int32_t* __restrict__ acc,
                                  int32_t* __restrict__ psqt,
                                  int32_t* __restrict__ err) {
  const int b = blockIdx.x >> 1;
  const int p = blockIdx.x & 1;
  const int tid = threadIdx.x;
  const int code = parent[b];
  if (code < 0) return;
  const int ref = code >> 1;
  if (ref >= batch || parent[ref] >= 0) {
    if (tid == 0 && p == 0) atomicAdd(err, 1);
    return;
  }
  const int64_t src = static_cast<int64_t>(ref) * 2 + (p ^ (code & 1));
  const int64_t dst = static_cast<int64_t>(b) * 2 + p;
  const int lane0 = tid * kLanes;
  int32_t a[kLanes];
  const int4 lo = *reinterpret_cast<const int4*>(acc + dst * l1 + lane0);
  const int4 hi = *reinterpret_cast<const int4*>(acc + dst * l1 + lane0 + 4);
  a[0] = lo.x; a[1] = lo.y; a[2] = lo.z; a[3] = lo.w;
  a[4] = hi.x; a[5] = hi.y; a[6] = hi.z; a[7] = hi.w;
  add_row32(a, acc + src * l1 + lane0);
  store_row32(acc + dst * l1 + lane0, a);
  if (kWithPsqt && tid < kPsqtBuckets)
    psqt[dst * kPsqtBuckets + tid] += psqt[src * kPsqtBuckets + tid];
}

template <bool kWithPsqt>
void launch(const int16_t* ft_w, int n_rows, int l1, const int16_t* ft_b,
            const int32_t* ft_psqt, const int32_t* idx, int batch,
            const int32_t* parent, const int32_t* anchor_tab,
            const int32_t* psqt_tab, int n_anchor, int delta_base,
            int32_t* acc, int32_t* psqt, int32_t* err, cudaStream_t stream) {
  const dim3 grid(2 * batch), block(l1 / kLanes);
  ft_gather_kernel<kWithPsqt><<<grid, block, 0, stream>>>(
      ft_w, n_rows, l1, ft_b, ft_psqt, idx, parent, anchor_tab, psqt_tab,
      n_anchor, delta_base, acc, psqt, err);
  if (parent != nullptr)
    ft_resolve_kernel<kWithPsqt><<<grid, block, 0, stream>>>(
        parent, batch, l1, acc, psqt, err);
}

}  // namespace

// C entry point, bound with ctypes by fishnet_tpu_torch/ops/ft_gather.py.
// Shapes: ft_w [n_rows, l1] int16 (last row the zero sentinel); ft_b [l1]
// int16; ft_psqt [n_rows, 8] int32 or NULL (no PSQT output); idx
// [batch, 2, 32] int32; parent [batch] int32 or NULL (every entry full);
// anchor_tab [n_anchor, 2, l1] / psqt_tab [n_anchor, 2, 8] int32 or NULL;
// delta_base < 0 disables removal decoding. Outputs acc [batch, 2, l1]
// and psqt [batch, 2, 8] int32; err is one int32 counter. l1 must be a
// multiple of 8 and at most 8192, every pointer 16-byte aligned (the
// wrapper checks). Launches on `stream` without synchronising and returns
// cudaGetLastError().
extern "C" int fc_ft_gather(const void* ft_w, int n_rows, int l1,
                            const void* ft_b, const void* ft_psqt,
                            const void* idx, int batch, const void* parent,
                            const void* anchor_tab, const void* psqt_tab,
                            int n_anchor, int delta_base, void* acc,
                            void* psqt, void* err, void* stream) {
  if (batch > 0) {
    const auto* w = static_cast<const int16_t*>(ft_w);
    const auto* bias = static_cast<const int16_t*>(ft_b);
    const auto* pq = static_cast<const int32_t*>(ft_psqt);
    const auto* ix = static_cast<const int32_t*>(idx);
    const auto* par = static_cast<const int32_t*>(parent);
    const auto* tab = static_cast<const int32_t*>(anchor_tab);
    const auto* ptab = static_cast<const int32_t*>(psqt_tab);
    auto* out = static_cast<int32_t*>(acc);
    auto* pout = static_cast<int32_t*>(psqt);
    auto* e = static_cast<int32_t*>(err);
    auto s = static_cast<cudaStream_t>(stream);
    if (pq != nullptr)
      launch<true>(w, n_rows, l1, bias, pq, ix, batch, par, tab, ptab,
                   n_anchor, delta_base, out, pout, e, s);
    else
      launch<false>(w, n_rows, l1, bias, pq, ix, batch, par, tab, ptab,
                    n_anchor, delta_base, out, pout, e, s);
  }
  return static_cast<int>(cudaGetLastError());
}
