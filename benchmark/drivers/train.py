"""Training traffic: `Trainer.train_step` over a seeded pool of batches
replayed in order, `utterances_per_step` utterances a step split into
`accumulated_steps` micro-batches, the batch padded to its longest
utterance. What depends on the model comes from `cell.family`.

Set-up builds the trainer once and drives it through its first steps on
the pool's first batches, recording what the check compares (each step's
losses; each leaf's gradient as Adam received it, from its first moment
after step 1; each leaf's change after `checked_steps`), then through the
rest of the pool once, so that every shape the window uses has run. The
window issues whole steps until `seconds` have passed and ends at a device
sync.
"""

import time

import numpy as np
import torch

from benchmark import costs, data, harness
from benchmark.reference import train as ref_train



class Driver:
    def __init__(self, cell, seed: int, device, root: str):
        cfg, tr = cell.config, cell.traffic
        self.spec, self.train_cfg, self.tr = cfg["model"], cfg["train"], tr
        self.device, self.family = device, cell.family
        self.tseed = data.torch_seed(seed, 7) % (2 ** 31)
        model, state = self.family.build_model(
            self.spec, self.train_cfg["route"], data.torch_seed(seed, 0),
            device)
        self.P0 = {k: state[k] for k, _ in model.named_parameters()}
        del state
        self.model = model
        self.trainer = self.family.trainer(model, self.train_cfg, self.tseed,
                                           device)
        self.calls = self.family.kernel_calls(model, training=True)
        n, steps = tr["utterances_per_step"], tr["pool_steps"]
        samples = data.utterance_samples(tr, n * steps, seed)
        self.pool, self.audio_s, self.flops = [], [], []
        for i in range(steps):
            s = samples[i * n:(i + 1) * n]
            self.pool.append(self.family.train_batch(
                self.spec, s, tr, seed * 64 + i, device))
            self.audio_s.append(data.real_seconds(s))
            frames = int(data.video_frames(s).max())
            self.flops.append(3.0 * self.family.forward_flops(
                self.spec, n, int(s.max()), frames))
        self.readings = self._first_steps()
        for i in range(self.checked, steps):
            self._step(i)
        self.next = 0
        torch.cuda.synchronize() if device.type == "cuda" else None

    def _step(self, i):
        return self.trainer.train_step(
            self.pool[i], accumulated_steps=self.tr["accumulated_steps"])

    def _first_steps(self):
        self.checked = self.tr["checked_steps"]
        opt = self.trainer.optimizer.optimizer
        b1 = opt.param_groups[0]["betas"][0]
        names = [n for n, _ in self.model.named_parameters()]
        params = [p for _, p in self.model.named_parameters()]
        losses = []
        grad = None
        for i in range(self.checked):
            out, _ = self._step(i)
            losses.append({k: float(v) for k, v in out.items()})
            if i == 0:
                grad = torch.stack([
                    opt.state[p].get("exp_avg", torch.zeros_like(p)).norm()
                    / (1 - b1) for p in params]).tolist()
        change = torch.stack([(p.detach() - self.P0[n]).norm()
                              for n, p in zip(names, params)]).tolist()
        return {"losses": losses, "grad_norm": dict(zip(names, grad)),
                "change": dict(zip(names, change))}

    # ---------------------------------------------------------- window
    def window(self, seconds: float) -> dict:
        sync = torch.cuda.synchronize if self.device.type == "cuda" else (
            lambda: None)
        sync()
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        steps, audio_s, flops = 0, 0.0, 0.0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            i = self.next % len(self.pool)
            self._step(i)
            steps, audio_s, flops = (steps + 1, audio_s + self.audio_s[i],
                                     flops + self.flops[i])
            self.next += 1
        sync()
        window_s = time.perf_counter() - t0
        self.window_info = {"steps": steps, "window_s": window_s,
                            "flops": flops}
        return {"train_audio_s_per_s": audio_s / window_s}

    def counts(self):
        """(steps attempted in the window, steps failed)."""
        return self.window_info["steps"], 0

    def slice(self):
        """The traced slice: `trace_steps` more steps."""
        self.calls.calls, self.calls.active = [], True
        for _ in range(self.tr["trace_steps"]):
            self._step(self.next % len(self.pool))
            self.next += 1
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        self.calls.active = False

    def layer_ctx(self, summary) -> dict:
        return {"kind": "train", "window": self.window_info,
                "trace": summary, "steps_in_slice": self.tr["trace_steps"],
                "kernel_bound_s": costs.kernel_bounds(self.calls.calls)}

    # ----------------------------------------------------------- check
    def release_program(self):
        self.calls.remove()
        self.trainer = self.model = self.calls = None
        harness.release()

    def _reference(self, fp8: bool = False, half: bool = False) -> dict:
        """The reference's readings on the checked batches; `half` keeps
        the first half of each micro-batch's rows (a planted fault)."""
        accum = self.tr["accumulated_steps"]
        batches = []
        for b in self.pool[:self.checked]:
            rows = [x for x in b["inputs"]], *b["targets"]
            if half:
                n = b["targets"][0].shape[0]
                m = n // accum
                keep = torch.cat([torch.arange(a * m, a * m + m // 2)
                                  for a in range(accum)]).to(self.device)
                rows = [x[keep] for x in rows[0]], rows[1][keep], rows[2][keep]
            batches.append({"inputs": rows[0], "labels": rows[1],
                            "label_len": rows[2]})
        return ref_train.train_readings(
            self.family.reference_forward, self.spec,
            {**self.train_cfg, "accumulated_steps": accum},
            self.P0, batches, self.tseed, fp8=fp8)

    def check(self) -> dict:
        return compare(self.readings, self._reference())

    def control(self, fault: str = "fp8") -> dict:
        """The numbers of the reference in a lower precision (`fp8`), or
        with half of each micro-batch left out (`half`), in the program's
        place."""
        want = self._reference()
        got = self._reference(fp8=fault == "fp8", half=fault == "half")
        got["losses"] = [{("loss" if k == "loss" else "loss_" + k): v
                          for k, v in step.items()} for step in got["losses"]]
        return compare(got, want)


def compare(got: dict, want: dict) -> dict:
    """The numbers held against their limits: the widest relative gap of a
    step's loss (every head and the weighted total); the worst leaf's gap
    between the norms of the first gradient, and of the change after the
    checked steps, each against the larger of the reference's norm of that
    leaf and of the median leaf. Leaves whose reference gradient is under a
    thousandth of the median leaf's (a bias that a softmax or a batch norm
    cancels) move by round-off alone and are left out of the change."""
    loss_gap = 0.0
    for g, w in zip(got["losses"], want["losses"]):
        for key, ref_v in w.items():
            k = "loss" if key == "loss" else "loss_" + key
            if k not in g:
                continue
            loss_gap = max(loss_gap, _gap(g[k], ref_v, abs(ref_v)))
    gr = want["grad_norm"]
    gm = float(np.median(list(gr.values())))
    grads = {k: _gap(got["grad_norm"][k], gr[k], max(gr[k], gm)) for k in gr}
    grad_gap = max(grads.values())
    keep = [k for k in gr if gr[k] >= 1e-3 * gm]
    cr = want["change"]
    cm = float(np.median([cr[k] for k in keep]))
    updates = {k: _gap(got["change"][k], cr[k], max(cr[k], cm))
               for k in keep}
    update_gap = max(updates.values())
    worst = lambda d: sorted(d, key=d.get, reverse=True)[:3]  # noqa: E731
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "update_gap": update_gap,
            "grad_leaves": {k: [grads[k], gr[k] / gm] for k in worst(grads)},
            "update_leaves": {k: [updates[k], cr[k] / cm]
                              for k in worst(updates)}}


def _gap(got: float, want: float, scale: float) -> float:
    """|got - want| / scale; infinite where either side is not finite."""
    gap = abs(got - want) / max(scale, 1e-30)
    return gap if np.isfinite(gap) else float("inf")
