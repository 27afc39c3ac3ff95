#!/usr/bin/env python3
"""The AV-Tone learning run of the PyTorch/H100 port on two kernel routes,
from one seed, to compare what each branch of the model learns.

Run from the repository root on a machine with an NVIDIA H100:

    python3 tools/torch_av_tone_routes.py [--steps-per-epoch N]
        [--out chiprun_out/av_tone_routes.json]

and on the CPU, cut to a few small steps, to try the script itself:

    python3 tools/torch_av_tone_routes.py --device cpu --steps-per-epoch 2 \
        --batch-size 2 --eval-samples 4 --out build/av_tone_routes_cpu.json

For each route, the fused-conv route of `chip_smoke.py` phase 18 (fused
FFN, attention and convolution modules, stem "pallas") and the plain route
(plain PyTorch modules, stem "2d", no kernel of the port), it builds the
AV-Tone setup (`avec_tpu_torch/configs/av_tone.py`: bf16 on fp32
parameters, dropout and SpecAugment on, seed 0) and trains it with `fit`
for the config's 2 epochs (400 steps each unless `--steps-per-epoch` cuts
them), without EMA, evaluations or checkpoints. It prints per route the
mean of each loss over every 100 steps and, after training, the greedy WER
of the 64 evaluation utterances through each CTC head: "outputs" (the
fusion's output), "f_ctc_0" (the fusion's interCTC head), "v_ctc_1" (the
video branch's) and "a_ctc_1", "a_ctc_3" (the audio branch's, which see
the audio alone), and of "outputs" with the video zeroed. The two routes
draw different dropout masks, so their losses agree as two runs of one
model do, not step for step. One JSON line with everything and the card's
name and power limit goes to stdout and to `--out`.

Imports nothing of JAX.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import torch

ROUTES = {
    "fused_conv": dict(fused_ffn=True, fused_att=True, fused_conv=True,
                       stem_mode="pallas"),
    "plain": dict(fused_ffn=False, fused_att=False, fused_conv=False,
                  stem_mode="2d", use_flash=False),
}
HEADS = ("outputs", "f_ctc_0", "v_ctc_1", "a_ctc_1", "a_ctc_3")
WINDOW = 100


def head_wers(trainer, loader, zero_video, tokenizer_path: str) -> dict:
    """Greedy WER (recomputed over the gathered transcripts) through each
    CTC head, and of "outputs" with the video zeroed: the greedy decoder of
    the setup's tokenizer, not the config's beam decoder."""
    from avec_tpu_torch.decode.greedy import CTCGreedySearchDecoder
    from avec_tpu_torch.train.metrics import WordErrorRate

    metrics, decoders = trainer.metrics, trainer.decoders
    decoder = CTCGreedySearchDecoder(tokenizer_path)
    out = {}
    try:
        for head in HEADS:
            trainer.metrics = {head: WordErrorRate()}
            trainer.decoders = {head: decoder}
            out[head] = trainer.evaluate(loader, recompute_metrics=True)[1][
                "wer"]
        trainer.metrics = {"outputs": WordErrorRate()}
        trainer.decoders = {"outputs": decoder}
        out["outputs_video_zeroed"] = trainer.evaluate(
            zero_video(loader), recompute_metrics=True)[1]["wer"]
    finally:
        trainer.metrics, trainer.decoders = metrics, decoders
    return out


def run_route(name: str, route: dict, root: str, args) -> dict:
    from avec_tpu_torch.configs import av_tone
    import chip_smoke as cs

    t0 = time.perf_counter()
    cut = {k: getattr(args, k) for k in ("batch_size", "eval_samples")
           if getattr(args, k) is not None}
    setup = av_tone.build(tempfile.mkdtemp(prefix=name + "_", dir=root),
                          device=args.device, route=route, **cut)
    trainer = setup.trainer
    per_step = []
    step = trainer.train_step

    def recording_step(batch, accumulated_steps=1):
        losses, infos = step(batch, accumulated_steps)
        per_step.append({k: v.detach() for k, v in losses.items()})
        return losses, infos

    trainer.train_step = recording_step
    init = head_wers(trainer, setup.eval_loader, cs._ZeroVideo,
                     setup.tokenizer_path)
    history = trainer.fit(setup.train_loader, setup.epochs,
                          steps_per_epoch=args.steps_per_epoch,
                          saving_period_epoch=None, eval_period_epoch=None,
                          step_log_period=200)
    del trainer.train_step
    keys = list(per_step[0])
    stacked = {k: torch.stack([s[k] for s in per_step]).float().cpu()
               for k in keys}
    windows = []
    for a in range(0, len(per_step), WINDOW):
        windows.append({"steps": [a + 1, min(a + WINDOW, len(per_step))],
                        **{k: float(v[a:a + WINDOW].mean())
                           for k, v in stacked.items()}})
    trained = head_wers(trainer, setup.eval_loader, cs._ZeroVideo,
                        setup.tokenizer_path)
    return {"route": route, "steps": len(per_step),
            "kernel_launches_per_step":
                setup.model.kernel_launches_per_step(),
            "epoch_losses": [h["losses"] for h in history],
            "window_means": windows, "wer_init": init, "wer_trained": trained,
            "seconds": time.perf_counter() - t0}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps-per-epoch", type=int, default=None)
    ap.add_argument("--batch-size", type=int, default=None)
    ap.add_argument("--eval-samples", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="chiprun_out/av_tone_routes.json")
    args = ap.parse_args()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("CUDA is not available", file=sys.stderr)
            return 1
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip()
    else:
        card = args.device
    build = os.path.join(root, "build")
    os.makedirs(build, exist_ok=True)
    work = tempfile.mkdtemp(prefix="av_tone_routes_", dir=build)
    result = {"card": card, "routes": {}}
    try:
        for name, route in ROUTES.items():
            res = run_route(name, route, work, args)
            result["routes"][name] = res
            for w in res["window_means"]:
                print(f"{name} steps {w['steps'][0]}-{w['steps'][1]}: "
                      + ", ".join(f"{k} {v:.3f}" for k, v in w.items()
                                  if k != "steps"), flush=True)
            print(f"{name} greedy WER at init: " + json.dumps(
                res["wer_init"]), flush=True)
            print(f"{name} greedy WER trained: " + json.dumps(
                res["wer_trained"]), flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(card)
    line = json.dumps(result)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
