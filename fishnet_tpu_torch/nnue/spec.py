"""The fishnet-tpu NNUE architecture specification.

Architecture: **HalfKAv2_hm feature set + SFNNv5-shaped network**, the
family used by the reference's embedded Stockfish 15 net
(``nn-ad9b42354671.nnue``, reference build.rs:7). All tensor shapes and
the serialization layout follow the public Stockfish/nnue-pytorch
format; the quantized arithmetic below is specified exactly so that the
C++ scalar evaluator (cpp/src/nnue.cpp) and the batched JAX evaluator
(fishnet_tpu/nnue/jax_eval.py) are bit-identical — that equivalence is
this framework's score-parity oracle (SURVEY.md §4), since no pretrained
net ships in this environment.

Feature set (HalfKAv2_hm):
    For each perspective p (side to move first):
      k0      = ksq(p) ^ (p == BLACK ? 56 : 0)        # color flip
      mirror  = file(k0) >= 4                          # horizontal mirror
      okq     = k0 ^ (mirror ? 7 : 0)
      bucket  = rank(okq) * 4 + file(okq)              # 0..31
      For every piece (c, t) on square s:
        osq   = s ^ (p == BLACK ? 56 : 0) ^ (mirror ? 7 : 0)
        plane = t == KING ? 10 : 2 * t + (c != p)      # 0..10
        index = bucket * 704 + plane * 64 + osq        # 0..22527
    <= 32 active features per perspective (all pieces incl. both kings).

Network (int quantization in brackets):
    ft:    22528 -> 1024 [w,b int16] + 8 PSQT outputs [int32]
    acc    = b + sum of active rows            (int32 math, int16 range)
    c      = clamp(acc, 0, 127)
    pair_i = (c_i * c_{i+512}) >> 7            # 512 per perspective, u8
    x      = concat(pair[stm], pair[opp])      # 1024
    bucket = (popcount(occupied) - 1) // 4     # 8 layer-stack buckets
    l1:    1024 -> 16 [w int8, b int32]; y = W x + b
    skip   = y[15]                             # direct residual neuron
    h      = y[0:15]
    act    = concat(min(127, (h*h) >> 19), clamp(h >> 6, 0, 127))  # 30
    l2:    30 -> 32 [w int8, b int32]; z = clamp((W act + b) >> 6, 0, 127)
    out:   32 -> 1  [w int8, b int32]; v = W z + b
    material   = (psqt[stm][bucket] - psqt[opp][bucket]) / 2
    positional = v + skip + (skip * 23) / 127   # == v + skip*9600/8128
    value      = (positional + material) / 16           # centipawns

    All `/` above are C-style truncating integer divisions (toward zero);
    all `>>` are arithmetic (flooring) shifts. The JAX evaluator
    reproduces exactly these semantics.

Divergence note vs. real SF15 nets — what IS and IS NOT verified
offline (this environment has no network egress and no pretrained net):

  Verified offline:
  * Field order, dtypes, and padded widths of the serialization match
    the documented SF/nnue-pytorch layout, via an independent bytewise
    golden-vector fixture (tests/test_nnue.py
    test_nnue_golden_byte_layout), including the 30->32 padded l2 rows.
  * The arithmetic follows the published SFNNv5 operator set
    (SqrClippedReLU >> 19, ClippedReLU >> 6, pairwise >> 7, FV_SCALE
    16), and the C++ scalar and JAX batched evaluators agree bit for
    bit on random nets and positions — including incremental (delta)
    entries and search-level results at fixed depth.

  NOT verifiable offline (would need a real nn-*.nnue file):
  * The section-hash constants (FT 0x5D69D5B8, stack 0x63337156): the
    loader deliberately skips them rather than verifying.
  * That FILE_VERSION/ARCH_HASH match the bytes of the shipped SF15
    net, and end-to-end score parity against stock Stockfish on it.
  The authoritative offline contract is therefore C++ == JAX on any
  weights this framework loads or trains.
"""

from __future__ import annotations

# Feature transformer
NUM_PLANES = 11
NUM_SQ = 64
NUM_KING_BUCKETS = 32
FEATURES_PER_BUCKET = NUM_PLANES * NUM_SQ  # 704
NUM_FEATURES = NUM_KING_BUCKETS * FEATURES_PER_BUCKET  # 22528
MAX_ACTIVE_FEATURES = 32
#: Incremental (delta) entries encode "remove feature f" as the index
#: DELTA_BASE + f (still uint16; cpp/src/nnue.h NNUE_DELTA_BASE). The
#: evaluators decode by subtraction and SUBTRACT those rows — the table
#: itself stays single-copy (a negated-copy table was tried and cost
#: ~25% extra gather time from the doubled random-read working set).
#: Wire contract per perspective of a delta entry: added features in
#: slots [0, DELTA_SLOTS), removals in [DELTA_SLOTS, 2*DELTA_SLOTS),
#: each region padded with its own sentinel (NUM_FEATURES, resp.
#: DELTA_BASE + NUM_FEATURES); slots beyond are plain sentinel.
DELTA_BASE = NUM_FEATURES + 1
DELTA_SLOTS = 4

L1 = 1024  # feature-transformer width
L1_HALF = L1 // 2  # pairwise-multiplied halves
NUM_PSQT_BUCKETS = 8
L2 = 15  # l1 outputs going through activations (+1 skip neuron)
L3 = 32

# Quantization
FT_CLIP = 127
PAIRWISE_SHIFT = 7
WEIGHT_SCALE_BITS = 6
SQR_SHIFT = 2 * WEIGHT_SCALE_BITS + PAIRWISE_SHIFT  # 19
FV_SCALE = 16
SKIP_NUM = 600 * FV_SCALE  # skip-neuron scale numerator
SKIP_DEN = 127 * (1 << WEIGHT_SCALE_BITS)

# Serialization (little-endian), nnue-pytorch/SF compatible framing
FILE_VERSION = 0x7AF32F20
ARCH_HASH = 0x3E5AA6EE  # HalfKAv2_hm + SFNNv5 stack (public constant)
#: SF's AffineTransform serializes weights over inputs PADDED to a
#: multiple of 32 (SIMD register width): the 30-wide l2 layer occupies
#: 32 int8 per output row on disk, the two pad columns zero. l1 (1024)
#: and out (32) are already aligned.
L2_PADDED_INPUTS = 32
ARCH_DESCRIPTION = (
    b"Features=HalfKAv2_hm(Friend)[22528->1024x2],"
    b"Network=AffineTransform[1->32](ClippedReLU[32](AffineTransform[32->30]"
    b"(SqrClippedReLU+ClippedReLU[15](AffineTransform[15+1<-1024]))))"
)


def psqt_bucket(piece_count: int) -> int:
    """Layer-stack / PSQT bucket from total piece count (1..32)."""
    return min(NUM_PSQT_BUCKETS - 1, max(0, (piece_count - 1) // 4))
