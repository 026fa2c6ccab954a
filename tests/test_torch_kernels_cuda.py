"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on the card.  Every test is marked ``cuda`` and skips without a
CUDA device (a CUDA kernel has no CPU mode).  The file imports neither JAX
nor the JAX package, so on the card machine it runs with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py

(tests/conftest.py imports JAX, which that machine does not have).

Tolerances: 1e-4 absolute for h, c and the gate gradient dxw (float32
against float32 with another summation order); dW_h sums B(T-1) 3xTF32
products (float32-accurate, csrc/lstm_bptt.cu), so it is held to 1e-4 of
its largest entry.

Two serving modules run on the card against the CPU at their shipped
widths (``chip_smoke``'s configs): the merged learned postfilter, float32
convolutions within 1e-4 of its output's largest entry, and the
multitrack acoustic model's ``inference_main`` at B = 1 (the per-pair
path), its output within 1e-3 and its modules held as ``chip_smoke``'s
``hold_modules`` holds them; and the diffusion voice's bap chain, its
noise drawn on the card and replayed on the CPU, within 1e-4 of its
largest entry.  The neural vocoders' generators (tiny widths, and the
recipe's hn-uSFGAN at full width through ``USFGANWrapper``) run on the
card against the CPU within 1e-4 of their output's largest entry; so do
the shipped vocoder configs' discriminators, feature map by feature map,
and one tiny GAN step of each vocoder family holds its losses within 1e-5
relative and its gradients within 1e-4 of their norm (or, where the
float32 runs differ by more, against the float64 step; the float64 runs
on the card and the CPU agree within 1e-9).
"""

import pytest
import torch

from ensemble_svs_with_interactions_tpu_torch.ops.lstm_recurrence import (
    lstm_bptt,
    lstm_bptt_kernel_name,
    lstm_dwh,
    lstm_dwh_reference,
    lstm_gates,
    lstm_gates_reference,
    lstm_recurrence,
    lstm_recurrence_bwd,
    lstm_recurrence_bwd_reference,
    lstm_recurrence_kernel_name,
    lstm_recurrence_reference,
    lstm_recurrence_trainable,
)

ATOL = 1e-4
DWH_RTOL = 1e-4
FLAGSHIP_H = [62, 64, 256, 512]
SMALL_H = [1, 8, 32, 62, 64]  # every padded width of the H <= 64 kernels
# the H > 64 group kernels (forward and BPTT): their three register widths
# (NC = 2, 4, 8), rows of h, c and dy that are not 16-byte multiples (98),
# unit blocks that are ragged (98, 100)
GROUP_H = [98, 100, 128, 256, 512]
# shapes whose xw the test hands over 4 bytes past a 16-byte boundary
MISALIGNED = {(1, 6653, 62), (1, 6653, 512)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _inputs(cuda, B, T, H, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    xw = torch.randn(B, T, 4 * H, device=cuda, generator=g)
    w_h = torch.randn(H, 4 * H, device=cuda, generator=g) / H ** 0.5
    dy = torch.randn(B, T, H, device=cuda, generator=g)
    return xw, w_h, dy


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H", [
    (4, 333, 62), (4, 333, 64), (4, 333, 256), (4, 333, 512),  # inference
    (1, 1, 8), (5, 37, 8),  # H <= 64: one block per batch row
    (9, 41, 100), (3, 29, 1024),  # multi-block with a ragged last block
    # training batches: more blocks than the card holds at one group per
    # grid row, so grid rows take several groups (and 67 a ragged one)
    *[(B, 256, H) for B in (64, 67) for H in FLAGSHIP_H],
    (128, 16, 512),
    # the group kernel (64 < H <= 512): every register width, one and two
    # steps and an odd length, groups of 4 rows (B <= 4) and of 16, ragged
    # last groups; blocks taking several groups (128, 300); the serving
    # length; and the widths above 512 on the mma kernel
    *[(B, T, H) for H in GROUP_H for B in (1, 3, 4, 5, 16, 17, 64, 67)
      for T in (1, 2, 37)],
    (128, 37, 512), (300, 9, 512), (4, 6656, 512), (32, 9, 1024),
    # the mma kernel (512 < H <= 1024): the recipe's 64 crops, 128 rows, a
    # ragged 70 at 640 (tiles of 64 rows, ragged m16 tiles)
    (64, 31, 1024), (128, 5, 1024), (70, 9, 640),
    # a batch the earlier H > 512 kernel refused for residency (more than
    # 128 rows at H = 1024) and one it took (300 at 640, where 4 of its
    # blocks fit an SM); the NPSS recipe's full batch of 64 x
    # 128 decoder steps and its dev pass, 1 x 1984; a width whose k16
    # blocks run past H (1000), one whose rows of h are not 16-byte
    # multiples (999: 4-byte copies) with a ragged last block of units;
    # more rows than one launch takes (600: two launches)
    (200, 33, 1024), (300, 9, 640), (64, 128, 1024), (1, 1984, 1024),
    (17, 37, 1000), (5, 9, 999), (600, 5, 768),
    # single-singer serving (SPSVS.svs): one row over the fixture's padded
    # length at every serving width, and an odd length whose xw starts
    # off a 16-byte boundary (MISALIGNED)
    *[(1, 6656, H) for H in (62, 64, 256, 512)], *sorted(MISALIGNED),
    # the mel voice's svs(): its DDPM's condition encoder at H = 128 over
    # the fixture (the group kernel at one row), and an odd length
    (1, 6656, 128), (1, 6653, 128),
    # the multi-speaker voice's train step: its 512 x 3 encoder over the
    # recipe's 4 crops of 256 frames (the group kernel)
    (4, 256, 512),
])
def test_lstm_recurrence_kernel_matches_plain(cuda, B, T, H):
    xw, w_h, _ = _inputs(cuda, B, T, H, B * 1000 + H)
    if (B, T, H) in MISALIGNED:
        buf = torch.empty(xw.numel() + 1, device=cuda)
        xw = buf[1:].view_as(xw).copy_(xw)
        assert xw.data_ptr() % 16
    before = lstm_recurrence.launches
    y, c = lstm_recurrence(xw, w_h, want_c=True)
    y_only = lstm_recurrence(xw, w_h)
    y_ref, c_ref = lstm_recurrence_reference(xw, w_h, want_c=True)
    torch.cuda.synchronize()
    assert lstm_recurrence.launches == before + 2
    assert (y - y_ref).abs().max().item() < ATOL
    assert (c - c_ref).abs().max().item() < ATOL
    assert torch.equal(y, y_only)


@pytest.mark.cuda
def test_lstm_recurrence_dispatch(cuda):
    """The kernel each width and batch runs: the train step's H = 256 and
    512 forwards on the group kernel, H <= 64 on the one-row-a-block
    kernel, H > 512 on the 3xTF32 mma kernel."""
    for B in (64, 67, 4, 200):
        assert lstm_recurrence_kernel_name(B, 62) == (
            "lstm_recurrence_small_kernel")
        for H in (520, 640, 1000, 1024):
            assert lstm_recurrence_kernel_name(B, H) == (
                "lstm_recurrence_mma_kernel")
    for H in (256, 512):
        assert lstm_recurrence_kernel_name(64, H) == (
            "lstm_recurrence_group_kernel")
    # one row, as SPSVS.svs runs every recurrence
    for H in (62, 64):
        assert lstm_recurrence_kernel_name(1, H) == (
            "lstm_recurrence_small_kernel")
    for H in (256, 512):
        assert lstm_recurrence_kernel_name(1, H) == (
            "lstm_recurrence_group_kernel")
    assert lstm_recurrence_kernel_name(1, 1024) == (
        "lstm_recurrence_mma_kernel")


@pytest.mark.cuda
def test_lstm_bptt_dispatch(cuda):
    """The loop kernel the BPTT runs after its gate pre-pass: H <= 64 on
    the one-row-a-block kernel, 64 < H <= 512 on the group kernel, H > 512
    on the 3xTF32 mma kernel, at every batch."""
    for B in (1, 4, 8, 9, 64, 67, 600, 3072):
        for H in (8, 62, 64):
            assert lstm_bptt_kernel_name(B, H) == "lstm_bptt_small_kernel"
        for H in (98, 256, 512):
            assert lstm_bptt_kernel_name(B, H) == "lstm_bptt_group_kernel"
        for H in (520, 640, 1000, 1024):
            assert lstm_bptt_kernel_name(B, H) == "lstm_bptt_mma_kernel"


@pytest.mark.cuda
def test_lstm_recurrence_refuses_wider_than_1024(cuda):
    """H > 1024 raises naming the width (a warp's part of W_h would
    outgrow its registers), as the BPTT does."""
    xw, w_h, _ = _inputs(cuda, 2, 3, 1032, 0)
    before = lstm_recurrence.launches
    with pytest.raises(ValueError, match="H = 1032"):
        lstm_recurrence(xw, w_h)
    assert lstm_recurrence.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H", [(67, 37, 98), (67, 40, 256), (4, 300, 512),
                                   (300, 9, 512), (64, 37, 1024),
                                   (3, 50, 768)])
def test_lstm_recurrence_kernel_is_deterministic(cuda, B, T, H):
    """Two launches on the same inputs give bitwise equal h and c: the
    warps' partial sums meet in a fixed order, with no atomics."""
    xw, w_h, _ = _inputs(cuda, B, T, H, 41)
    y1, c1 = lstm_recurrence(xw, w_h, want_c=True)
    y2, c2 = lstm_recurrence(xw, w_h, want_c=True)
    torch.cuda.synchronize()
    assert torch.equal(y1, y2) and torch.equal(c1, c2)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H", [(3, 50, 256), (3, 50, 512), (20, 50, 512)])
def test_group_forward_saturates_like_the_plain_loop(cuda, B, T, H):
    """Gate pre-activations up to about +-200 at 64 < H <= 512: the group
    kernel's hardware exp2 / reciprocal activations saturate to the same
    0, 1 and -1 as the plain loop's."""
    xw, w_h, _ = _inputs(cuda, B, T, H, 43)
    xw *= 40.0
    w_h *= 10.0
    y, c = lstm_recurrence(xw, w_h, want_c=True)
    y_ref, c_ref = lstm_recurrence_reference(xw, w_h, want_c=True)
    torch.cuda.synchronize()
    assert torch.isfinite(y).all() and torch.isfinite(c).all()
    assert (y - y_ref).abs().max().item() < ATOL
    assert (c - c_ref).abs().max().item() < ATOL


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H", [(3, 50, 1024), (70, 50, 1024)])
def test_mma_forward_saturates_like_the_plain_loop(cuda, B, T, H):
    """Gate pre-activations up to about +-200 at H = 1024: the mma kernel's
    3xTF32 products (operands split into TF32 hi and lo parts) and its
    activations saturate to the same 0, 1 and -1 as the plain loop's."""
    xw, w_h, _ = _inputs(cuda, B, T, H, 43)
    xw *= 40.0
    w_h *= 10.0
    y, c = lstm_recurrence(xw, w_h, want_c=True)
    y_ref, c_ref = lstm_recurrence_reference(xw, w_h, want_c=True)
    torch.cuda.synchronize()
    assert torch.isfinite(y).all() and torch.isfinite(c).all()
    assert (y - y_ref).abs().max().item() < ATOL
    assert (c - c_ref).abs().max().item() < ATOL


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H", [
    # every padded width (32: H = 1, 8, 32; 64: H = 62, 64) at one step, an
    # odd length and the serving length; batches of one block up to nearly
    # one block per SM
    *[(B, T, H) for H in (1, 8, 32, 62, 64)
      for B in (1, 3, 4, 5, 64, 67, 128) for T in (1, 37)],
    *[(4, 6656, H) for H in (1, 8, 32, 62, 64)],
    # more rows than the card holds blocks at once: later blocks queue
    (301, 17, 62), (600, 9, 64), (1200, 5, 32),
])
def test_small_width_forward_matches_plain(cuda, B, T, H):
    """The H <= 64 forward kernel (W_h in registers, one block per batch
    row) against the plain loop, both modes."""
    xw, w_h, _ = _inputs(cuda, B, T, H, B * 100 + T + H)
    before = lstm_recurrence.launches
    y, c = lstm_recurrence(xw, w_h, want_c=True)
    y_only = lstm_recurrence(xw, w_h)
    y_ref, c_ref = lstm_recurrence_reference(xw, w_h, want_c=True)
    torch.cuda.synchronize()
    assert lstm_recurrence.launches == before + 2
    assert (y - y_ref).abs().max().item() < ATOL
    assert (c - c_ref).abs().max().item() < ATOL
    assert torch.equal(y, y_only)


@pytest.mark.cuda
@pytest.mark.parametrize("H", [8, 62, 64])
def test_small_width_forward_saturates_like_the_plain_loop(cuda, H):
    """Gate pre-activations far outside [-1, 1] (up to about +-200): the
    H <= 64 kernel's hardware exp2 / reciprocal activations saturate to the
    same 0, 1 and -1 as expf and tanhf."""
    xw, w_h, _ = _inputs(cuda, 3, 50, H, 13)
    xw *= 40.0
    w_h *= 10.0
    y, c = lstm_recurrence(xw, w_h, want_c=True)
    y_ref, c_ref = lstm_recurrence_reference(xw, w_h, want_c=True)
    torch.cuda.synchronize()
    assert torch.isfinite(y).all() and torch.isfinite(c).all()
    assert (y - y_ref).abs().max().item() < ATOL
    assert (c - c_ref).abs().max().item() < ATOL


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H", [
    (1, 2, 62), (1, 2, 100), (1, 2, 8), (1, 1, 64),  # one step, or none
    (3, 50, 62), (5, 37, 100), (2, 300, 36),  # ragged tiles and k-tiles
    (64, 256, 62), (64, 64, 256),
])
def test_dwh_kernel_ragged_shapes(cuda, B, T, H):
    """dW_h alone against its plain version where the reduction, the tile
    or the 16-byte rows are ragged (H = 62: 4-byte copies)."""
    g = torch.Generator(device=cuda).manual_seed(B + T + H)
    h = torch.randn(B, T, H, device=cuda, generator=g)
    dz = torch.randn(B, T, 4 * H, device=cuda, generator=g)
    before = lstm_dwh.launches
    got = lstm_dwh(h, dz)
    ref = lstm_dwh_reference(h, dz)
    torch.cuda.synchronize()
    assert lstm_dwh.launches == before + 1
    if T == 1:
        assert not got.any()
        return
    scale = ref.abs().max().item()
    assert (got - ref).abs().max().item() < DWH_RTOL * scale


@pytest.mark.cuda
def test_dwh_kernel_stays_float32_accurate_over_a_long_reduction(cuda):
    """16,368 steps per slice at H = 512: the tensor core's accumulator
    sums one k8 step at a time, so the error does not grow with the slice
    (in an accumulator carried over the whole slice it grows with the
    slice's length)."""
    B, T, H = 64, 1024, 512
    g = torch.Generator(device=cuda).manual_seed(7)
    h = torch.randn(B, T, H, device=cuda, generator=g)
    dz = torch.randn(B, T, 4 * H, device=cuda, generator=g)
    got = lstm_dwh(h, dz)
    ref = lstm_dwh_reference(h, dz)
    torch.cuda.synchronize()
    assert (got - ref).abs().max().item() < DWH_RTOL * ref.abs().max().item()


@pytest.mark.cuda
def test_dwh_kernel_takes_rows_that_are_not_16_byte_aligned(cuda):
    """Operands that start 4 bytes into their storage take the 4-byte
    copies; the result is the same sum."""
    B, T, H = 3, 40, 64
    g = torch.Generator(device=cuda).manual_seed(3)
    hbuf = torch.randn(B * T * H + 1, device=cuda, generator=g)
    zbuf = torch.randn(B * T * 4 * H + 1, device=cuda, generator=g)
    h = hbuf[1:].view(B, T, H)
    dz = zbuf[1:].view(B, T, 4 * H)
    got = lstm_dwh(h, dz)
    aligned = lstm_dwh(h.clone(), dz.clone())
    ref = lstm_dwh_reference(h, dz)
    torch.cuda.synchronize()
    scale = ref.abs().max().item()
    assert (got - ref).abs().max().item() < DWH_RTOL * scale
    assert (aligned - ref).abs().max().item() < DWH_RTOL * scale


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H", [
    *[(64, 256, H) for H in FLAGSHIP_H], (64, 64, 256),
])
def test_dwh_kernel_is_deterministic(cuda, B, T, H):
    """Two launches on the same inputs give bitwise equal dW_h: the split
    over the reduction is summed in a fixed order, with no atomics."""
    g = torch.Generator(device=cuda).manual_seed(H + T)
    h = torch.randn(B, T, H, device=cuda, generator=g)
    dz = torch.randn(B, T, 4 * H, device=cuda, generator=g)
    first = lstm_dwh(h, dz)
    second = lstm_dwh(h, dz)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H", [
    (1, 1, 8), (5, 37, 8), (3, 20, 62), (9, 41, 100),
    *[(4, 200, H) for H in FLAGSHIP_H],
    *[(B, 256, H) for B in (64, 67) for H in FLAGSHIP_H],
    # the mel voice's train step: 4 crops of 256 frames through the
    # biLSTMs at H = 64 and 128, the AR lf0 cell (256) over 256 / 4 steps
    (4, 256, 64), (4, 256, 128), (4, 64, 256),
    # the multi-speaker voice's train step: the 512 x 3 encoder at 4 x 256
    (4, 256, 512),
])
def test_lstm_bptt_and_dwh_kernels_match_plain(cuda, B, T, H):
    xw, w_h, dy = _inputs(cuda, B, T, H, B * 7 + H)
    h, c = lstm_recurrence_reference(xw, w_h, want_c=True)
    before = (lstm_bptt.launches, lstm_dwh.launches)
    dxw, dwh = lstm_recurrence_bwd(xw, w_h, h, c, dy)
    dxw_ref, dwh_ref = lstm_recurrence_bwd_reference(xw, w_h, h, c, dy)
    dwh_own = lstm_dwh_reference(h, dxw_ref)
    torch.cuda.synchronize()
    assert (lstm_bptt.launches, lstm_dwh.launches) == (before[0] + 1,
                                                       before[1] + 1)
    assert (dxw - dxw_ref).abs().max().item() < ATOL
    scale = max(dwh_ref.abs().max().item(), 1e-30)
    assert (dwh - dwh_ref).abs().max().item() < DWH_RTOL * scale
    # the dW_h kernel alone against its own plain version, same dz
    dwh_k = lstm_dwh(h, dxw_ref)
    assert (dwh_k - dwh_own).abs().max().item() < DWH_RTOL * scale


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H", [
    # every padded width at one and two steps, an odd length; batches of
    # one block up to nearly one block per SM
    *[(B, T, H) for H in SMALL_H
      for B in (1, 3, 4, 5, 64, 67, 128) for T in (1, 2, 37)],
    (64, 256, 62), (64, 256, 64),  # the train step's shapes
    *[(4, 1000, H) for H in SMALL_H],  # reverse-time error growth
    # more rows than the card holds blocks at once: later blocks queue
    (301, 17, 62), (600, 9, 64), (1200, 5, 32),
])
def test_small_width_bptt_matches_plain(cuda, B, T, H):
    """The H <= 64 BPTT (gate pre-pass, then the loop with W_h in registers,
    one block per batch row) against the plain loop."""
    xw, w_h, dy = _inputs(cuda, B, T, H, B * 10 + T + H)
    h, c = lstm_recurrence_reference(xw, w_h, want_c=True)
    before = (lstm_bptt.launches, lstm_gates.launches)
    dxw = lstm_bptt(xw, w_h, h, c, dy)
    dxw_ref, _ = lstm_recurrence_bwd_reference(xw, w_h, h, c, dy)
    torch.cuda.synchronize()
    assert (lstm_bptt.launches, lstm_gates.launches) == (before[0] + 1,
                                                         before[1])
    assert (dxw - dxw_ref).abs().max().item() < ATOL


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H", [
    # every register width and a ragged batch group; the train step's
    # shapes; the reverse-time error over 1000 steps; more groups than the
    # card holds at once (a block takes several in each step)
    *[(B, T, H) for H in GROUP_H for B in (1, 3, 4, 5, 64, 67)
      for T in (1, 2, 37)],
    (64, 256, 256), (64, 256, 512), (4, 1000, 512),
    (128, 16, 512), (300, 9, 512),
])
def test_group_bptt_matches_plain(cuda, B, T, H):
    """The 64 < H <= 512 BPTT (the 3xTF32 gate pre-pass, then the loop
    whose grid splits the units and the batch) against the plain loop."""
    xw, w_h, dy = _inputs(cuda, B, T, H, B * 10 + T + H)
    h, c = lstm_recurrence_reference(xw, w_h, want_c=True)
    before = (lstm_bptt.launches, lstm_gates.launches)
    dxw = lstm_bptt(xw, w_h, h, c, dy)
    dxw_ref, _ = lstm_recurrence_bwd_reference(xw, w_h, h, c, dy)
    torch.cuda.synchronize()
    assert (lstm_bptt.launches, lstm_gates.launches) == (before[0] + 1,
                                                         before[1])
    assert (dxw - dxw_ref).abs().max().item() < ATOL


# the 512 < H <= 1024 BPTT loop (lstm_bptt_mma_kernel): a ragged unit
# block (644), the widths between, the mgc decoder's 1024
SPLIT_H = [644, 768, 1024]


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H", [
    *[(B, T, H) for H in SPLIT_H for B in (1, 3, 9) for T in (1, 2, 37)],
    (64, 128, 1024), (36, 64, 1024), (4, 301, 640), (17, 33, 1000),
    # the edges of the loop's plan: the FMA and tensor-core paths (batches
    # of 8 and 9 rows), ragged tiles of 64 rows (63, 65, and 72: a last
    # tile of 8 rows on the tensor cores after a full one), more rows than
    # one launch takes (600: two launches), and a batch the H > 512 loop
    # before it refused for shared memory (3072 rows at H = 1024)
    (8, 37, 1024), (9, 37, 1024), (63, 9, 1024), (65, 9, 1024),
    (72, 5, 1024), (600, 3, 1024), (3072, 2, 1024),
])
def test_split_bptt_matches_plain(cuda, B, T, H):
    """The 512 < H <= 1024 BPTT (the 3xTF32 gate pre-pass, then the loop
    that multiplies all rows of a reverse step at once, 3xTF32 mma.sync or
    FMAs for batches of up to 8 rows) against the plain loop, counted as
    one launch;
    an xw that starts 4 bytes past a 16-byte boundary gives the same
    dxw."""
    xw, w_h, dy = _inputs(cuda, B, T, H, B * 10 + T + H)
    h, c = lstm_recurrence_reference(xw, w_h, want_c=True)
    before = (lstm_bptt.launches, lstm_gates.launches)
    dxw = lstm_bptt(xw, w_h, h, c, dy)
    dxw_ref, _ = lstm_recurrence_bwd_reference(xw, w_h, h, c, dy)
    torch.cuda.synchronize()
    assert (lstm_bptt.launches, lstm_gates.launches) == (before[0] + 1,
                                                         before[1])
    assert (dxw - dxw_ref).abs().max().item() < ATOL
    if T == 37:
        moved = lstm_bptt(_unaligned(xw), w_h, h, c, dy)
        assert (moved - dxw_ref).abs().max().item() < ATOL


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H", [(64, 128, 1024), (4, 33, 1024)])
def test_split_bptt_is_deterministic(cuda, B, T, H):
    """Two launches of the 512 < H <= 1024 BPTT on the same inputs give
    bitwise equal dxw: the warps' partial sums meet in a fixed order, with
    no atomics (the tensor-core path at 64 rows, the FMA path at 4)."""
    xw, w_h, dy = _inputs(cuda, B, T, H, 43)
    h, c = lstm_recurrence_reference(xw, w_h, want_c=True)
    first = lstm_bptt(xw, w_h, h, c, dy)
    second = lstm_bptt(xw, w_h, h, c, dy)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
def test_split_bptt_saturates_and_trains(cuda):
    """Gate pre-activations up to about +-200 at H = 1024 saturate as the
    plain loop's do; the autograd Function's (dxw, dW_h) at H = 768 match
    the plain backward."""
    xw, w_h, dy = _inputs(cuda, 3, 21, 1024, 23)
    xw *= 40.0
    w_h *= 10.0
    h, c = lstm_recurrence_reference(xw, w_h, want_c=True)
    dxw = lstm_bptt(xw, w_h, h, c, dy)
    dxw_ref, _ = lstm_recurrence_bwd_reference(xw, w_h, h, c, dy)
    assert torch.isfinite(dxw).all()
    assert (dxw - dxw_ref).abs().max().item() < ATOL
    xw, w_h, dy = _inputs(cuda, 5, 19, 768, 29)
    xw.requires_grad_(True)
    w_h.requires_grad_(True)
    (lstm_recurrence_trainable(xw, w_h) * dy).sum().backward()
    h, c = lstm_recurrence_reference(xw.detach(), w_h.detach(), want_c=True)
    dxw_ref, dwh_ref = lstm_recurrence_bwd_reference(xw.detach(),
                                                     w_h.detach(), h, c, dy)
    assert (xw.grad - dxw_ref).abs().max().item() < ATOL
    scale = dwh_ref.abs().max().item()
    assert (w_h.grad - dwh_ref).abs().max().item() < DWH_RTOL * scale


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H", [
    (1, 1, 1), (3, 37, 8), (5, 2, 32), (67, 37, 62), (64, 256, 64),
    (4, 1000, 62), (600, 9, 64),
    # the tensor-core pre-pass: 4-byte copies (98, 100 is H % 4 == 0 but
    # ragged tiles), the train step's shapes
    (3, 37, 98), (5, 29, 100), (64, 256, 256), (64, 256, 512),
])
def test_gate_prepass_matches_plain(cuda, B, T, H):
    """The gate pre-pass alone: act(xw_t + h_{t-1} W_h) for every step."""
    xw, w_h, _ = _inputs(cuda, B, T, H, B + T + H)
    h = torch.rand(B, T, H, device=cuda) * 2.0 - 1.0
    before = lstm_gates.launches
    got = lstm_gates(xw, w_h, h)
    ref = lstm_gates_reference(xw, w_h, h)
    torch.cuda.synchronize()
    assert lstm_gates.launches == before + 1
    assert (got - ref).abs().max().item() < ATOL


@pytest.mark.cuda
@pytest.mark.parametrize("H", [8, 62, 64])
def test_small_width_bptt_saturates_like_the_plain_loop(cuda, H):
    """Gate pre-activations up to about +-200: the pre-pass's activations
    and the loop's tanh of c saturate as the plain loop's do."""
    xw, w_h, dy = _inputs(cuda, 3, 50, H, 17)
    xw *= 40.0
    w_h *= 10.0
    h, c = lstm_recurrence_reference(xw, w_h, want_c=True)
    gates = lstm_gates(xw, w_h, h)
    dxw = lstm_bptt(xw, w_h, h, c, dy)
    dxw_ref, _ = lstm_recurrence_bwd_reference(xw, w_h, h, c, dy)
    torch.cuda.synchronize()
    assert torch.isfinite(dxw).all()
    assert (gates - lstm_gates_reference(xw, w_h, h)).abs().max().item() < ATOL
    assert (dxw - dxw_ref).abs().max().item() < ATOL


@pytest.mark.cuda
@pytest.mark.parametrize("H", [256, 512])
def test_group_bptt_saturates_like_the_plain_loop(cuda, H):
    """Gate pre-activations up to about +-200 at H > 64: the tensor-core
    pre-pass and the group loop saturate as the plain loop does."""
    xw, w_h, dy = _inputs(cuda, 3, 50, H, 19)
    xw *= 40.0
    w_h *= 10.0
    h, c = lstm_recurrence_reference(xw, w_h, want_c=True)
    gates = lstm_gates(xw, w_h, h)
    dxw = lstm_bptt(xw, w_h, h, c, dy)
    dxw_ref, _ = lstm_recurrence_bwd_reference(xw, w_h, h, c, dy)
    torch.cuda.synchronize()
    assert torch.isfinite(dxw).all()
    assert (gates - lstm_gates_reference(xw, w_h, h)).abs().max().item() < ATOL
    assert (dxw - dxw_ref).abs().max().item() < ATOL


def _unaligned(t):
    """A copy of ``t`` that starts 4 bytes into its storage."""
    v = torch.empty(t.numel() + 1, device=t.device)[1:].view(t.shape)
    return v.copy_(t)


@pytest.mark.cuda
@pytest.mark.parametrize("H", [98, 512])
def test_group_bptt_takes_inputs_that_are_not_16_byte_aligned(cuda, H):
    """Every input 4 bytes into its storage, at H > 64: the pre-pass takes
    the 4-byte copies, the loop reads c, dy and the gates as floats, and
    the result is bitwise the aligned one."""
    B, T = 5, 33
    xw, w_h, dy = _inputs(cuda, B, T, H, 29)
    h, c = lstm_recurrence_reference(xw, w_h, want_c=True)
    args = [_unaligned(t) for t in (xw, w_h, h, c, dy)]
    assert all(a.data_ptr() % 16 for a in args)
    got = lstm_bptt(*args)
    gates = lstm_gates(*args[:3])
    torch.cuda.synchronize()
    assert torch.equal(got, lstm_bptt(xw, w_h, h, c, dy))
    assert torch.equal(gates, lstm_gates(xw, w_h, h))


@pytest.mark.cuda
@pytest.mark.parametrize("H", [62, 64])
def test_small_width_bptt_takes_inputs_that_are_not_16_byte_aligned(cuda, H):
    """Every input starting 4 bytes into its storage is taken (the pre-pass
    reads floats, the loop copies c and dy rows 4 bytes at a time, and
    reads the gates back from dxw, which the wrapper allocates): the same
    result as from aligned copies."""
    B, T = 3, 40
    xw, w_h, dy = _inputs(cuda, B, T, H, 23)
    h, c = lstm_recurrence_reference(xw, w_h, want_c=True)
    args = [_unaligned(t) for t in (xw, w_h, h, c, dy)]
    assert all(a.data_ptr() % 16 for a in args)
    got = lstm_bptt(*args)
    aligned = lstm_bptt(xw, w_h, h, c, dy)
    gates = lstm_gates(*args[:3])
    dxw_ref, _ = lstm_recurrence_bwd_reference(xw, w_h, h, c, dy)
    torch.cuda.synchronize()
    assert torch.equal(got, aligned)
    assert torch.equal(gates, lstm_gates(xw, w_h, h))
    assert (got - dxw_ref).abs().max().item() < ATOL


@pytest.mark.cuda
@pytest.mark.parametrize("H", [62, 64, 256, 512])
def test_bptt_padding_suffix_gives_zero_gradient(cuda, H):
    """A row whose dy is zero on a suffix gets dxw = 0 there, and the same
    valid-step gradients as the row cut to its valid length."""
    B, T = 3, 40
    xw, w_h, dy = _inputs(cuda, B, T, H, 11)
    dy[1, 25:] = 0.0
    h, c = lstm_recurrence(xw, w_h, want_c=True)
    dxw = lstm_bptt(xw, w_h, h, c, dy)
    assert not dxw[1, 25:].any()
    cut = lstm_bptt(xw[1:2, :25].contiguous(), w_h, h[1:2, :25].contiguous(),
                    c[1:2, :25].contiguous(), dy[1:2, :25].contiguous())
    assert (dxw[1:2, :25] - cut).abs().max().item() < ATOL


@pytest.mark.cuda
@pytest.mark.parametrize("H", [62, 64, 256, 512])
def test_autograd_function_gradients_on_the_card(cuda, H):
    """The Function's gradients (BPTT and dW_h kernels) against autograd
    through the plain loop in float64 on the same card."""
    B, T = 6, 50
    xw, w_h, dy = _inputs(cuda, B, T, H, 5)
    xw.requires_grad_(True)
    w_h.requires_grad_(True)
    before = lstm_bptt.launches
    y = lstm_recurrence_trainable(xw, w_h)
    gx, gw = torch.autograd.grad((y * dy).sum(), (xw, w_h))
    assert lstm_bptt.launches == before + 1
    xw64 = xw.detach().double().requires_grad_(True)
    w64 = w_h.detach().double().requires_grad_(True)
    y64 = lstm_recurrence_reference(xw64, w64)
    rx, rw = torch.autograd.grad((y64 * dy.double()).sum(), (xw64, w64))
    assert (y.double() - y64).abs().max().item() < ATOL
    assert (gx.double() - rx).abs().max().item() < ATOL
    assert (gw.double() - rw).abs().max().item() < DWH_RTOL * rw.abs().max()


@pytest.mark.cuda
def test_lstm_recurrence_rejects_what_the_kernel_does_not_take(cuda):
    xw = torch.randn(2, 5, 32, device=cuda)
    w_h = torch.randn(8, 32, device=cuda)
    with pytest.raises(ValueError, match="float32"):
        lstm_recurrence(xw.double(), w_h.double())
    with pytest.raises(ValueError, match="do not form"):
        lstm_recurrence(xw, w_h[:, :16])
    # a non-contiguous xw, or one whose rows are not 16-byte aligned (the
    # H <= 64 kernel streams them in 16-byte copies), is copied first
    strided = xw.transpose(0, 1)
    assert torch.equal(lstm_recurrence(strided, w_h),
                       lstm_recurrence(strided.contiguous(), w_h))
    assert torch.equal(lstm_recurrence(_unaligned(xw), w_h),
                       lstm_recurrence(xw, w_h))


@pytest.mark.cuda
@pytest.mark.parametrize("H", [62, 64, 98, 256, 512])
def test_lstm_recurrence_takes_any_layout_of_xw(cuda, H):
    """A non-contiguous xw (a slice of a wider projection) and an xw 4 bytes
    into its storage give bitwise the aligned, contiguous result, in both
    modes."""
    xw, w_h, _ = _inputs(cuda, 3, 40, H, 37)
    wide = torch.cat([xw, xw[..., :8]], dim=-1)[..., :4 * H]
    assert not wide.is_contiguous()
    for want_c in (False, True):
        want = lstm_recurrence(xw, w_h, want_c)
        for got in (lstm_recurrence(wide, w_h, want_c),
                    lstm_recurrence(_unaligned(xw), w_h, want_c)):
            pairs = zip(got, want) if want_c else [(got, want)]
            assert all(torch.equal(a, b) for a, b in pairs)


@pytest.mark.cuda
def test_kernels_launch_on_the_device_of_their_tensors(cuda):
    """With device 0 current, the forward, the BPTT and dW_h on cuda:1
    tensors launch on cuda:1 and match their plain versions there."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    dev = torch.device("cuda", 1)
    with torch.cuda.device(0):
        for H in (64, 256, 512):
            xw, w_h, dy = _inputs(dev, 5, 30, H, H)
            y, c = lstm_recurrence(xw, w_h, want_c=True)
            y_ref, c_ref = lstm_recurrence_reference(xw, w_h, want_c=True)
            dxw, dwh = lstm_recurrence_bwd(xw, w_h, y_ref, c_ref, dy)
            dxw_ref, dwh_ref = lstm_recurrence_bwd_reference(xw, w_h, y_ref,
                                                             c_ref, dy)
            torch.cuda.synchronize(dev)
            assert torch.cuda.current_device() == 0
            assert {t.device for t in (y, c, dxw, dwh)} == {dev}
            assert (y - y_ref).abs().max().item() < ATOL
            assert (c - c_ref).abs().max().item() < ATOL
            assert (dxw - dxw_ref).abs().max().item() < ATOL
            scale = dwh_ref.abs().max().item()
            assert (dwh - dwh_ref).abs().max().item() < DWH_RTOL * scale


@pytest.mark.cuda
def test_backward_kernels_reject_what_they_do_not_take(cuda):
    xw = torch.randn(2, 5, 32, device=cuda)
    w_h = torch.randn(8, 32, device=cuda)
    h = torch.randn(2, 5, 8, device=cuda)
    with pytest.raises(ValueError, match="float32"):
        lstm_bptt(xw, w_h, h, h, h.double())
    with pytest.raises(ValueError, match="do not form"):
        lstm_bptt(xw, w_h, h, h, h[:, :4])
    with pytest.raises(ValueError, match="float32"):
        lstm_dwh(h.half(), xw.half())
    # 8 rows of the BPTT's W_h sit in a block's shared memory: H <= 1024
    h_big = torch.randn(1, 2, 1025, device=cuda)
    with pytest.raises(ValueError, match="H = 1025.*H <= 1024"):
        lstm_bptt(torch.randn(1, 2, 4 * 1025, device=cuda),
                  torch.randn(1025, 4 * 1025, device=cuda), h_big, h_big,
                  h_big)
    # non-contiguous inputs are copied first
    strided = h.transpose(0, 1).contiguous().transpose(0, 1)
    assert torch.equal(lstm_bptt(xw, w_h, h, strided, h),
                       lstm_bptt(xw, w_h, h, h, h))
    dz = xw.transpose(0, 1).contiguous().transpose(0, 1)
    assert torch.equal(lstm_dwh(h, dz), lstm_dwh(h, xw))
    # the gate pre-pass alone serves every H
    wide = torch.randn(2, 5, 4 * 100, device=cuda)
    w_wide = torch.randn(100, 400, device=cuda) / 10.0
    h_wide = torch.rand(2, 5, 100, device=cuda) * 2.0 - 1.0
    got = lstm_gates(wide, w_wide, h_wide)
    want = lstm_gates_reference(wide, w_wide, h_wide)
    assert (got - want).abs().max().item() < ATOL


POSTFILTER_RTOL = 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("allow_tf32", [False, True])
def test_postfilter_on_the_card_matches_the_cpu(cuda, allow_tf32):
    """The merged postfilter (``chip_smoke.postfilter_config``: 64-channel
    5 x 5 mgc, 32-channel 5 x 1 bap) on a 512-frame slice with the same
    input and noise.  Its convolutions stay float32 when the caller turns
    cuDNN's TF32 on, and the caller's setting is left as it was."""
    import chip_smoke
    from ensemble_svs_with_interactions_tpu_torch.utils.config import (
        instantiate,
    )

    torch.manual_seed(0)
    module = instantiate(chip_smoke.postfilter_config()["netG"]).eval()
    g = torch.Generator().manual_seed(0)
    x = torch.randn(1, 512, 67, generator=g)
    noise = {"mgc": torch.randn(1, 512, 1, generator=g),
             "bap": torch.randn(1, 512, 5, generator=g)}
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = allow_tf32
    try:
        with torch.no_grad():
            ref = module.inference(x, noise=noise)
            got = module.to(cuda).inference(x.to(cuda), noise=noise).cpu()
        assert torch.backends.cudnn.allow_tf32 is allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = before
    err = ((got - ref).abs().max() / ref.abs().max()).item()
    assert err < POSTFILTER_RTOL, err
    assert not torch.allclose(ref, x)


@pytest.mark.cuda
def test_multitrack_inference_main_at_b1_matches_the_cpu(cuda):
    """The flagship's acoustic model (``chip_smoke.flagship_acoustic_config``)
    on one pair, main and sub track of 500 frames padded to 512, with the
    same dropout masks: ``inference_main`` within 1e-3, and its modules
    (the AR lf0 decoder against a float64 oracle) by ``hold_modules``."""
    import chip_smoke
    from ensemble_svs_with_interactions_tpu_torch.gen import AR_SEED
    from ensemble_svs_with_interactions_tpu_torch.utils.config import (
        instantiate,
    )

    torch.manual_seed(0)
    cpu = instantiate(chip_smoke.flagship_acoustic_config()[0]["netG"]).eval()
    card = instantiate(chip_smoke.flagship_acoustic_config()[0]["netG"])
    card.load_state_dict(cpu.state_dict())
    card = card.to(cuda).eval()
    g = torch.Generator().manual_seed(1)
    n, T = 500, 512
    xm, xs = torch.zeros(2, 1, T, 86)
    xm[:, :n], xs[:, :n] = torch.rand(2, 1, n, 86, generator=g)
    with torch.no_grad():
        outs = [m.inference_main(
            xm.to(dev), xs.to(dev),
            (torch.tensor([0], device=dev), torch.tensor([1], device=dev)),
            torch.tensor([n], device=dev),
            generator=torch.Generator().manual_seed(AR_SEED)).cpu()
            for m, dev in ((cpu, torch.device("cpu")), (card, cuda))]
    assert torch.isfinite(outs[1]).all()
    assert (outs[1] - outs[0])[:, :n].abs().max().item() < 1e-3
    valid = torch.arange(T)[None, :] < n
    held = chip_smoke.hold_modules(card, cpu, valid, xm.numpy(), xs.numpy(),
                                   [0], [1], [n])
    chip_smoke.assert_held(held)


@pytest.mark.cuda
@pytest.mark.parametrize("allow_tf32", [False, True])
def test_diffusion_chain_on_the_card_matches_the_cpu(cuda, allow_tf32):
    """The diffusion voice's bap chain at its shipped widths
    (``chip_smoke.diffusion_acoustic_config``: FFConvLSTM encoder, a
    10-layer 128-channel ``DiffNet``, 100 ancestral steps) on one 512-frame
    track: it draws its noise on the card from the card's generator, and
    the CPU, replaying that noise, gives the same samples within 1e-4 of
    their largest entry.  The chain stays float32 when the caller turns
    cuDNN's TF32 on, and the caller's setting is left as it was."""
    import chip_smoke
    from ensemble_svs_with_interactions_tpu_torch.models.diffsinger import (
        chain_noise,
    )
    from ensemble_svs_with_interactions_tpu_torch.utils.config import (
        instantiate,
    )

    torch.manual_seed(0)
    cfg = chip_smoke.diffusion_acoustic_config()["netG"]["bap_model"]
    cpu = instantiate(cfg).eval()
    card = instantiate(cfg)
    card.load_state_dict(cpu.state_dict())
    card = card.to(cuda).eval()
    g = torch.Generator().manual_seed(1)
    n, T = 500, 512
    x = torch.zeros(1, T, 87)
    x[:, :n] = torch.rand(1, n, 87, generator=g)
    spk = torch.randn(1, 1, 256, generator=g).expand(1, T, 256) * 0.01
    lengths = torch.tensor([n])
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = allow_tf32
    try:
        with chain_noise() as drawn:
            got = card.inference(
                x.to(cuda), lengths.to(cuda), spk_embs=spk.to(cuda),
                chain_generator=torch.Generator(cuda).manual_seed(2)).cpu()
        assert torch.backends.cudnn.allow_tf32 is allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = before
    with chain_noise(drawn):
        ref = cpu.inference(x, lengths, spk_embs=spk)
    (entry,) = drawn
    g2 = torch.Generator(cuda).manual_seed(2)
    x_T = torch.randn((1, T, 5), generator=g2, device=cuda).cpu()
    assert torch.equal(entry["x_T"], x_T)
    assert entry["steps"].shape == (100, 1, T, 5)
    assert torch.isfinite(got).all()
    err = ((got - ref)[:, :n].abs().max() / ref.abs().max()).item()
    assert err < 1e-4, err


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["pwg", "sifigan", "hifigan",
                                  "parallel_hn_usfgan"])
def test_vocoder_generator_on_the_card_matches_the_cpu(cuda, name):
    """The generators ``load_vocoder`` serves, at tiny widths with 240x
    upsampling (``chip_smoke.tiny_generators``), on the card against the
    CPU on the same inputs: within 1e-4 of the output's largest entry."""
    import chip_smoke

    net, S = chip_smoke.tiny_generators()[name]
    held = chip_smoke.hold_generator(net, S, cuda)
    assert held["finite"] and held["max_abs"] > 0
    assert held["rel_err"] < chip_smoke.VOCODER_RTOL, held


@pytest.mark.cuda
def test_recipe_vocoder_wrapper_on_the_card_matches_the_cpu(cuda):
    """The recipe's hn-uSFGAN (``chip_smoke.vocoder_phase``, full width)
    through ``USFGANWrapper`` on 40 frames: the card within 1e-4 of the
    CPU's largest sample, in float32 even when the caller turned cuDNN's
    TF32 on, and the caller's setting left as it was."""
    import numpy as np

    import chip_smoke
    from ensemble_svs_with_interactions_tpu_torch.svs import build_vocoder

    cfg, in_scaler, _ = chip_smoke.vocoder_phase()
    state = chip_smoke.random_state_dicts({"vocoder": (cfg, None, None)},
                                          0)["vocoder"]
    cpu, card = (build_vocoder(cfg, state, in_scaler, 48000, 5, dev)[0]
                 for dev in ("cpu", cuda))
    rng = np.random.default_rng(0)
    f0 = rng.uniform(100, 600, (40, 1)) * (rng.uniform(size=(40, 1)) > 0.2)
    aux = rng.standard_normal((40, 65)).astype(np.float32)
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        got = card.inference(f0, aux)
        assert torch.backends.cudnn.allow_tf32 is True
    finally:
        torch.backends.cudnn.allow_tf32 = before
    ref = cpu.inference(f0, aux)
    assert got.shape == ref.shape == (40 * 240,)
    assert np.isfinite(got).all()
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err < chip_smoke.VOCODER_RTOL, err


@pytest.mark.cuda
@pytest.mark.parametrize("rel", ["vocoder/vocoder_parallel_hn_usfgan.yaml",
                                 "vocoder/vocoder_sifigan.yaml",
                                 "vocoder/vocoder_pwg.yaml"])
def test_vocoder_discriminator_on_the_card_matches_the_cpu(cuda, rel):
    """The shipped vocoder configs' discriminators at their widths, with
    the flax schemes' weights, on one 64-frame crop at 48 kHz: every
    feature map on the card within 1e-4 of the CPU's largest entry."""
    import copy

    import chip_smoke
    from ensemble_svs_with_interactions_tpu_torch.utils.config import (
        instantiate,
    )
    from ensemble_svs_with_interactions_tpu_torch.utils.flax_init import (
        init_module,
    )
    from ensemble_svs_with_interactions_tpu_torch.utils.precision import (
        conv_precision,
    )

    cfg = chip_smoke.shipped_config(rel)["model"]["discriminator"]
    cpu = init_module(instantiate(cfg), seed=1)
    card = copy.deepcopy(cpu).to(cuda)
    gen = torch.Generator().manual_seed(0)
    x = 0.3 * torch.randn(1, 64 * 240, 1, generator=gen)
    with torch.no_grad(), conv_precision(cuda):
        got = card(x.to(cuda))
        ref = cpu(x)
    flat = [(g, r) for gs, rs in zip(got, ref) for g, r in zip(gs, rs)]
    assert len(flat) > 0
    for g, r in flat:
        assert g.shape == r.shape
        err = ((g.cpu() - r).abs().max() / r.abs().max()).item()
        assert err < 1e-4, err


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["hn_usfgan", "sifigan", "pwg"])
def test_vocoder_gan_step_on_the_card_matches_the_cpu(cuda, family,
                                                      tmp_path):
    """One GAN step of each tiny family (``chip_smoke.
    tiny_vocoder_trainings``) on the card against the CPU from the same
    weights and batch (``chip_smoke.hold_gan_step``): the losses within
    1e-5 relative, each network's gradient within 1e-4 of its L2 norm,
    or the card's float32 run no farther from the float64 step than 4x
    the CPU's; the float64 runs within 1e-9."""
    import chip_smoke

    corpus = chip_smoke.write_vocoder_corpus(tmp_path / "in", n=2,
                                             frames=80)
    cfg = chip_smoke.tiny_vocoder_trainings(corpus,
                                            tmp_path / "exp")[family]
    held = chip_smoke.hold_gan_step(cfg, cuda)
    assert held["ok"], held


@pytest.mark.cuda
def test_two_gloo_ranks_sharing_the_card_hold_the_one_process_step(
        cuda, tmp_path):
    """The flagship's train step at full width on two processes sharing
    the card over gloo (``chip_smoke.parallel_step_held``: a global batch
    of mixed lengths with a padding row, 3 SGD steps) against one process
    on the whole batch: the ranks in float64 on the CPU within 1e-9 of one
    process in float64, the card's ranks' summed gradients and parameters
    by the train step's rule against the CPU's float32 ranks with the
    float64 process as the oracle, the loss within 1e-4 of one process on
    the card, both ranks alike, each rank launching each LSTM kernel 46
    times a step, and ranks with batch norm unsynced refused."""
    import chip_smoke
    from ensemble_svs_with_interactions_tpu_torch.ops import (
        lstm_recurrence as lr,
    )

    held = chip_smoke.parallel_step_held(lr, tmp_path, "cuda")
    assert held["backend"] == "gloo" and held["ranks_agree"]
