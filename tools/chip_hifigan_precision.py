"""Where the card's float32 GAN step of the shipped HiFiGAN departs from
the CPU's, on one card.

    python3 tools/chip_hifigan_precision.py [--frames N] [--parts P,...]

``configs/vocoder/vocoder_hifigan.yaml`` at the shipped widths, one
``train_vocoder`` GAN step on one crop of N frames (default
``chip_smoke.HIFIGAN_CROP_FRAMES``) from the flax schemes' weights
(``chip_smoke.reference_gan_step``), the parts named (all by default):

* ``steps``: the step on the card in float32 with cuDNN's convolutions
  (as the trainer runs them, TF32 off) and with cuDNN disabled (torch's
  own CUDA convolutions), and in float64, against the CPU's float32 and
  float64 steps; ``chip_smoke.hold_runs``'s verdict and distances for
  each;
* ``generator``: the generator's float32 waveform on the CPU, and on the
  card with cuDNN and without, each one's relative L2 distance from the
  CPU's float64 waveform;
* ``stft_loss``: the multi-resolution STFT loss alone in float32, card
  (cuFFT) and CPU (``stft_floor``); and the float64 loss of
  each float32 waveform above, each term's relative distance from the
  float64 loss of the float64 waveform;
* ``g_grad``: where G's float32 gradient error enters.  The gradient of
  G's loss in the waveform (``u``) taken from the card's float32 step
  and the CPU's, against the float64 one; each carried back through the
  float64 generator; and the float64 ``u`` carried back through the
  float32 generator on the card and on the CPU: each one's L2 distance
  over its norm from the float64 gradient, and for the last the WORST
  parameter tensors by their share of its squared error;
* ``norm``: the gradient norm of one float32 step's G and D gradients,
  ``train/vocoder._global_norm`` against ``torch._foreach_norm`` and a
  sum of each tensor's squares: device ms a call (CUDA events, mean of
  NORM_CALLS) beside the step's own ms, and each one's relative distance
  from the float64 norm, on the card and on the CPU.

Prints one JSON object, then the card's name and power limit.  Exits
non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import sys
import tempfile
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402

NORM_CALLS = 20
WORST = 6
PARTS = ("generator", "g_grad", "norm", "steps")
F32, F64 = torch.float32, torch.float64


def cudnn(on: bool):
    """Enable or disable cuDNN; returns the value it had."""
    before = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = on
    return before


def steps(cfg) -> dict:
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    runs = {("cpu", dt): chip_smoke.reference_gan_step(cfg, cpu, dt)
            for dt in (F32, F64)}
    runs[("card", F64)] = chip_smoke.reference_gan_step(cfg, cuda, F64)
    out = {}
    for on in (True, False):
        before = cudnn(on)
        try:
            runs[("card", F32)] = chip_smoke.reference_gan_step(cfg, cuda,
                                                                F32)
        finally:
            cudnn(before)
        held = chip_smoke.hold_runs(runs)
        held.pop("metrics_card")
        out["cudnn_on" if on else "cudnn_off"] = held
    return out


def stft_floor(cfg, device) -> dict:
    """What float32 costs ``cfg``'s multi-resolution STFT loss alone, on
    ``device`` and on the CPU: the loss (``train/vocoder.stft_loss``) of
    the float64 generator's waveform on the first crop (``build_gan``'s
    weights) against the crop's target, taken in float32; the relative
    distance from the CPU's float64 loss of each term (``sc``, ``mag``),
    of their sum (``sum``), and of the sum's gradient in the waveform
    (``grad``, L2 over its norm)."""
    from ensemble_svs_with_interactions_tpu_torch.train import vocoder

    cpu = torch.device("cpu")
    _, gen, _ = chip_smoke.build_gan(cfg, cpu, torch.float64)
    batch = chip_smoke.vocoder_batches(cfg, 1, cpu, torch.float64)[0]
    t = cfg.train
    res = (list(t.fft_sizes), list(t.hop_sizes), list(t.win_lengths))
    with torch.no_grad():
        wave = gen(*vocoder.generator_inputs(
            batch, vocoder.generator_input_arity(gen)))[..., 0]

    def run(dev, dtype):
        w = wave.to(dev, dtype).requires_grad_()
        sc, mag = vocoder.stft_loss(w, batch["y"][..., 0].to(dev, dtype),
                                    *res)
        grad, = torch.autograd.grad(sc + mag, w)
        return sc.item(), mag.item(), grad.double().cpu()

    sc64, mag64, grad64 = run(cpu, torch.float64)
    out = {}
    for side, dev in (("card", device), ("cpu", cpu)):
        sc, mag, grad = run(dev, torch.float32)
        out[side] = {"sc": abs(sc - sc64) / sc64,
                     "mag": abs(mag - mag64) / mag64,
                     "sum": abs(sc + mag - sc64 - mag64) / (sc64 + mag64),
                     "grad": float((grad - grad64).norm() / grad64.norm())}
    return out


def rel(a, b) -> float:
    return float((a.double().cpu() - b).norm() / b.norm())


def generator_and_stft(cfg) -> tuple:
    from ensemble_svs_with_interactions_tpu_torch.train import vocoder
    from ensemble_svs_with_interactions_tpu_torch.utils.precision import (
        conv_precision,
    )

    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    _, gen, _ = chip_smoke.build_gan(cfg, cpu, F64)
    batch = chip_smoke.vocoder_batches(cfg, 1, cpu, F64)[0]
    t = cfg.train
    res = (list(t.fft_sizes), list(t.hop_sizes), list(t.win_lengths))
    inputs = vocoder.generator_inputs(
        batch, vocoder.generator_input_arity(gen))
    y = batch["y"][..., 0]
    terms = stft_floor(cfg, cuda)
    with torch.no_grad():
        ref = gen(*inputs)
        waves = {"cpu_f32": gen.float()(*(x.float() for x in inputs))}
        card = gen.cuda()
        for on in (True, False):
            before = cudnn(on)
            try:
                with conv_precision(cuda):
                    waves["card_f32_cudnn_" + ("on" if on else "off")] = (
                        card(*(x.float().cuda() for x in inputs)).cpu())
            finally:
                cudnn(before)

        def loss(wave):
            return [float(v) for v in vocoder.stft_loss(wave[..., 0], y,
                                                        *res)]

        sc64, mag64 = loss(ref)
        for name, w in waves.items():
            sc, mag = loss(w.double())
            terms[name + "_wave"] = {"sc": abs(sc - sc64) / sc64,
                                     "mag": abs(mag - mag64) / mag64}
    return {k: rel(w, ref) for k, w in waves.items()}, terms


def card_ms(fn, *args) -> float:
    fn(*args)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(NORM_CALLS):
        fn(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / NORM_CALLS


def norms(cfg) -> dict:
    from ensemble_svs_with_interactions_tpu_torch.train import vocoder

    def foreach_norm(grads):
        return torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm(grads)))

    def squares(grads):
        return torch.sqrt(sum((g * g).sum() for g in grads))

    cuda = torch.device("cuda")
    step, gen, dis = chip_smoke.build_gan(cfg, cuda, F32)
    batch = chip_smoke.vocoder_batches(cfg, 1, cuda, F32)[0]
    out = {"step_ms": card_ms(step, batch)}
    for net, module in (("G", gen), ("D", dis)):
        grads = [p.grad for p in module.parameters()]
        exact = float(squares([g.double() for g in grads]))
        row = {"tensors": len(grads),
               "elements": sum(g.numel() for g in grads)}
        for name, fn in (("global_norm", vocoder._global_norm),
                         ("foreach_norm", foreach_norm),
                         ("squares", squares)):
            row[name] = {
                "card_ms": card_ms(fn, grads),
                "card_rel": abs(float(fn(grads)) - exact) / exact,
                "cpu_rel": abs(float(fn([g.cpu() for g in grads])) - exact)
                / exact}
        out[net] = row
    return out


def step_upstream(cfg, device, dtype):
    """One GAN step of ``cfg`` on ``device`` in ``dtype``: the gradient
    of G's loss in G's waveform, float64 on the host."""
    step, gen, _ = chip_smoke.build_gan(cfg, device, dtype)
    got = {}

    def save(grad):
        got["u"] = grad.detach().double().cpu()

    def keep(module, inputs, out):
        wave = out[0] if isinstance(out, tuple) else out
        if wave.requires_grad and not got:
            wave.register_hook(save)

    hook = gen.register_forward_hook(keep)
    step(chip_smoke.vocoder_batches(cfg, 1, device, dtype)[0])
    hook.remove()
    return got["u"]


def g_grad(cfg) -> dict:
    from ensemble_svs_with_interactions_tpu_torch.train import vocoder

    cpu, cuda = torch.device("cpu"), torch.device("cuda")

    def carried(device, dtype, u):
        """G's gradient of ``u`` through the generator on ``device``
        in ``dtype``: {parameter name: float64 on the host}."""
        _, gen, _ = chip_smoke.build_gan(cfg, device, dtype)
        batch = chip_smoke.vocoder_batches(cfg, 1, device, dtype)[0]
        wave = gen(*vocoder.generator_inputs(
            batch, vocoder.generator_input_arity(gen)))
        names, params = zip(*gen.named_parameters())
        grads = torch.autograd.grad(wave, params,
                                    grad_outputs=u.to(device, dtype))
        return {n: g.double().cpu() for n, g in zip(names, grads)}

    def flat(grads):
        return torch.cat([g.reshape(-1) for g in grads.values()])

    def dist(grads, ref):
        return float((flat(grads) - flat(ref)).norm() / flat(ref).norm())

    def worst(grads, ref):
        """The WORST tensors by their share of the squared error: name,
        share, their own relative error and share of the gradient."""
        err = {n: float((grads[n] - r).norm() ** 2) for n, r in ref.items()}
        total, size = sum(err.values()), float(flat(ref).norm() ** 2)
        return [{"name": n, "err_share": err[n] / total,
                 "rel": (err[n] / max(float(ref[n].norm() ** 2), 1e-300))
                 ** 0.5, "grad_share": float(ref[n].norm() ** 2) / size}
                for n in sorted(err, key=err.get, reverse=True)[:WORST]]

    u64 = step_upstream(cfg, cpu, F64)
    ref = carried(cpu, F64, u64)
    out = {"u_norm": float(u64.norm())}
    for side, dev in (("card", cuda), ("cpu", cpu)):
        u = step_upstream(cfg, dev, F32)
        back = carried(dev, F32, u64)
        out[side] = {"u": float((u - u64).norm() / u64.norm()),
                     "u_through_f64": dist(carried(cpu, F64, u), ref),
                     "f64_u_through_f32": dist(back, ref),
                     "f64_u_through_f32_worst": worst(back, ref)}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int,
                    default=chip_smoke.HIFIGAN_CROP_FRAMES)
    ap.add_argument("--parts", default=",".join(PARTS),
                    help="comma-separated, of " + ", ".join(PARTS))
    args = ap.parse_args(argv)
    parts = args.parts.split(",")
    if not set(parts) <= set(PARTS):
        ap.error(f"--parts: not one of {PARTS}")
    if not torch.cuda.is_available():
        print("chip_hifigan_precision: no CUDA device", file=sys.stderr)
        return 2
    t0 = time.time()
    with tempfile.TemporaryDirectory() as root:
        corpus = chip_smoke.write_vocoder_corpus(Path(root) / "in", n=2,
                                                 frames=40)
        cfg = chip_smoke.vocoder_train_config(
            corpus, Path(root) / "exp", chip_smoke.VOCODER_HIFIGAN_CONFIG,
            data={"crop_frames": args.frames}, batch_size=1)
        out = {"config": chip_smoke.VOCODER_HIFIGAN_CONFIG,
               "frames": args.frames}
        if "generator" in parts:
            out["generator"], out["stft_loss"] = generator_and_stft(cfg)
        for name, fn in (("g_grad", g_grad), ("norm", norms),
                         ("steps", steps)):
            if name in parts:
                out[name] = fn(cfg)
    chip_smoke.emit({**out, "seconds": time.time() - t0})
    print(chip_smoke.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
