"""The AVEC family, the names the drivers call: the zoo's AV or AO
Efficient Conformer InterCTC ("kind" "av" or "ao"), inputs [video,
video_len,] audio, audio_len, requests {"audio"[, "video"]}, and the plain
reference `reference/model.py:forward`."""

from typing import Dict, Tuple

import torch

from benchmark import data, weights
from benchmark.reference.model import forward as reference_forward  # noqa


def model_kwargs(spec: dict, route: dict) -> dict:
    """The zoo class's keyword arguments for the architecture `spec` and
    the kernel `route` (use_flash, stem_mode, fused_ffn, fused_att,
    fused_conv)."""
    kw = dict(vocab_size=spec["vocab_size"],
              fused_ffn=route["fused_ffn"], fused_att=route["fused_att"],
              fused_conv=route["fused_conv"], use_flash=route["use_flash"])
    if spec["kind"] == "ao":
        kw.update(att_type=spec["att_type"],
                  interctc_blocks=list(spec["a_interctc_blocks"]),
                  num_blocks=list(spec["a_num_blocks"]))
    else:
        kw.update(v_num_blocks=list(spec["v_num_blocks"]),
                  a_num_blocks=list(spec["a_num_blocks"]),
                  f_num_blocks=spec["f_num_blocks"],
                  v_interctc_blocks=list(spec["v_interctc_blocks"]),
                  a_interctc_blocks=list(spec["a_interctc_blocks"]),
                  f_interctc_blocks=list(spec["f_interctc_blocks"]),
                  stem_mode=route["stem_mode"])
    return kw


def build_model(spec: dict, route: dict, seed: int, device
                ) -> Tuple[torch.nn.Module, Dict[str, torch.Tensor]]:
    """(the port's model on `device` with the benchmark's seeded weights,
    those weights as the benchmark made them: {name: tensor})."""
    from avec_tpu_torch.models import zoo

    cls = {"av": zoo.AudioVisualEfficientConformerInterCTC,
           "ao": zoo.AudioEfficientConformerInterCTC}[spec["kind"]]
    model = cls(device=device, **model_kwargs(spec, route))
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    state = weights.make_state(shapes, seed, device)
    model.load_state_dict(state, strict=True)
    return model, state


def trainer(model, train: dict, seed: int, device):
    from avec_tpu_torch.train.losses import CTCLoss
    from avec_tpu_torch.train.model import Trainer

    return Trainer(model=model, device=device, precision=train["precision"],
                   seed=seed, loss=CTCLoss(zero_infinity=True,
                                           assert_shorter=False),
                   loss_weights=dict(train["loss_weights"]), metrics=None)


def server(model, serve: dict, spec: dict, device):
    from avec_tpu_torch.serve import Server

    return Server(model=model.eval(), device=device,
                  precision=serve["precision"], mode=spec["kind"])


def train_batch(spec: dict, samples, traffic: dict, seed: int, device
                ) -> dict:
    """{"inputs", "targets"} of utterances of `samples` samples."""
    audio = data.audio(samples, seed, device)
    alen = torch.as_tensor(samples, dtype=torch.int32, device=device)
    labels, u = data.labels(samples, traffic, seed)
    if spec["kind"] == "ao":
        inputs = [audio, alen]
    else:
        f = data.video_frames(samples)
        inputs = [data.video(f, seed, device),
                  torch.as_tensor(f, dtype=torch.int32, device=device),
                  audio, alen]
    return {"inputs": inputs,
            "targets": (torch.as_tensor(labels, device=device),
                        torch.as_tensor(u, device=device))}


def requests(spec: dict, samples, seed: int, device) -> list:
    """The served requests of utterances of `samples` samples, on the host."""
    a = data.audio(samples, seed, device).cpu().numpy()
    f = data.video_frames(samples)
    v = (data.video(f, seed, device).cpu().numpy()
         if spec["kind"] == "av" else None)
    out = []
    for j, k in enumerate(samples):
        req = {"audio": a[j, :k].copy()}
        if v is not None:
            req["video"] = v[j, :f[j]].copy()
        out.append(req)
    return out


def served_batch(inputs) -> tuple:
    """((batch, samples[, frames]) of a served batch as padded, which
    `forward_flops` and `reference_inputs` take; each row's audio length)."""
    shape = (inputs[-1].shape[0], inputs[-2].shape[1])
    return (shape + ((inputs[0].shape[1],) if len(inputs) == 4 else ()),
            inputs[-1])


def reference_inputs(request: dict, shape: tuple, device) -> list:
    """The reference's inputs of one served request, padded as its batch
    was (`shape` from `served_batch`)."""
    a = torch.zeros((1, shape[1]), device=device)
    a[0, :len(request["audio"])] = torch.from_numpy(request["audio"])
    alen = torch.tensor([len(request["audio"])], device=device)
    if "video" not in request:
        return [a, alen]
    v = torch.zeros((1, shape[2], 88, 88, 1), device=device)
    v[0, :len(request["video"])] = torch.from_numpy(request["video"])
    vlen = torch.tensor([len(request["video"])], device=device)
    return [v, vlen, a, alen]


# ------------------------------------------------------------ model FLOPs
def _restride(t: int, s: int) -> int:
    return (t - 1) // s + 1


def _attention(b, t, d, heads=4):
    """q, k, v, out projections; the relative table (2T - 1 rows) through
    the positional projection; q against the table, q k^T, a v."""
    dh = d // heads
    return (8.0 * b * t * d * d + 2.0 * (2 * t - 1) * d * d
            + 2.0 * b * heads * t * (2 * t - 1) * dh
            + 4.0 * b * heads * t * t * dh)


def _stack(b, t, dims, num_blocks, interctc, kinds, vocab, k=15):
    flops = 0.0
    i = 0
    for stage, n in enumerate(num_blocks):
        d = dims[stage]
        for j in range(n):
            down = j == n - 1 and stage < len(num_blocks) - 1
            e = dims[stage + 1] if down else d
            s = 2 if down else 1
            t2 = _restride(t, s)
            flops += 2 * 2.0 * b * t * d * 4 * d           # ff1
            ta = -(-t // 3) if kinds[stage] == "patch" else t
            flops += _attention(b, ta, d)
            flops += 2.0 * b * t * d * 2 * e               # pw1
            flops += 2.0 * b * t2 * e * k                  # depthwise
            flops += 2.0 * b * t2 * e * e                  # pw2
            if e != d:
                flops += 2.0 * b * t2 * d * e              # strided shortcut
            flops += 2 * 2.0 * b * t2 * e * 4 * e          # ff2
            if i + 1 in interctc:
                flops += 4.0 * b * t2 * e * vocab
            t = t2
            i += 1
    return flops, t


def _audio(b, samples, spec):
    t = samples // 160 + 1
    flops = 2.0 * b * t * 257 * 80                         # mel filterbank
    t = _restride(t, 2)
    flops += 2.0 * b * 40 * t * 9 * 180                   # stem conv
    flops += 2.0 * b * t * 7200 * 180                      # stem linear
    kinds = ["patch" if spec["att_type"] == "patch" else "regular",
             "regular", "regular"]
    f, t = _stack(b, t, [180, 256, 360], spec["a_num_blocks"],
                  spec["a_interctc_blocks"], kinds, spec["vocab_size"])
    return flops + f, t


def _video(b, frames, spec):
    n = b * frames
    flops = 2.0 * n * 44 * 44 * 64 * 245                   # Conv3d stem
    hw, c = 22, 64
    for stage, dim in enumerate((64, 128, 256, 512)):
        for j in range(2):
            s = 2 if (j == 0 and stage > 0) else 1
            ho = _restride(hw, s)
            flops += 2.0 * n * ho * ho * dim * c * 9
            flops += 2.0 * n * ho * ho * dim * dim * 9
            if s != 1 or c != dim:
                flops += 2.0 * n * ho * ho * dim * c
            hw, c = ho, dim
    flops += 2.0 * n * 512 * 256                            # head
    f, _ = _stack(b, frames, [256, 360], spec["v_num_blocks"],
                  spec["v_interctc_blocks"], ["regular", "regular"],
                  spec["vocab_size"])
    return flops + f


def forward_flops(spec: dict, batch: int, samples: int, frames: int = 0
                  ) -> float:
    """Forward FLOPs of the model `spec` on a batch padded to `samples`
    audio samples (and `frames` video frames): the products of the plain
    reference (linear layers, convolutions, attention scores and values,
    the relative-position table's projection, the mel filterbank)."""
    fa, t = _audio(batch, samples, spec)
    if spec["kind"] == "ao":
        return fa + 2.0 * batch * t * 360 * spec["vocab_size"]
    fv = _video(batch, frames, spec)
    ff = 2.0 * batch * t * 720 * 1440 + 2.0 * batch * t * 1440 * 360
    fs, _ = _stack(batch, t, [360], [spec["f_num_blocks"]],
                   spec["f_interctc_blocks"], ["regular"],
                   spec["vocab_size"])
    return fa + fv + ff + fs + 2.0 * batch * t * 360 * spec["vocab_size"]


def kernel_modules():
    """The port's module classes whose calls launch its hand-written
    kernels: {kind: class}."""
    from avec_tpu_torch.models.conformer import (AttentionModule,
                                                 ConvolutionModule,
                                                 FeedForwardModule)
    from avec_tpu_torch.models.encoders import FusedVideoStem
    from avec_tpu_torch.ops.attention import RelPos1dMultiHeadAttention

    return {"ffn": FeedForwardModule, "att": AttentionModule,
            "conv": ConvolutionModule, "stem": FusedVideoStem,
            "flash": RelPos1dMultiHeadAttention}


class KernelCalls:
    """Records the shapes of the kernel-launching module calls while
    `active`, by forward pre-hooks on the model's own instances."""

    def __init__(self, model, training: bool):
        self.calls, self.active, self.training = [], False, training
        classes = kernel_modules()
        self.handles = []
        for m in model.modules():
            for kind, cls in classes.items():
                if type(m) is cls or (kind != "flash" and isinstance(m, cls)):
                    self.handles.append(m.register_forward_pre_hook(
                        self._hook(kind), with_kwargs=True))

    def _hook(self, kind):
        def hook(mod, args, kwargs):
            if self.active:
                call = self._shape(kind, mod, args, kwargs)
                if call is not None:
                    self.calls.append(call)
        return hook

    def _shape(self, kind, mod, args, kwargs):
        x = args[0]
        es = x.element_size()
        tr = self.training
        if kind == "ffn" and tr and mod.fused_eligible(x.ndim):
            b, t, d = x.shape
            return dict(kind="ffn", n=b * t, d=d,
                        f=mod.layers["1"].weight.shape[0], es=es,
                        backward=True)
        if kind == "att" and tr and mod.fused_eligible(x.ndim,
                                                       kwargs.get("mask")):
            b, t, d = x.shape
            return dict(kind="att", b=b, t=t, d=d,
                        heads=mod.attention.num_heads, es=es, backward=True)
        if kind == "conv" and tr and mod.fused_eligible(x.ndim):
            b, t, d = x.shape
            return dict(kind="conv", b=b, t=t, d=d,
                        e=mod.layers["1"].weight.shape[0] // 2,
                        eo=mod.layers["6"].weight.shape[0],
                        k=mod.layers["3"].weight.shape[-1], es=es,
                        backward=True)
        if kind == "stem" and mod.mode == "pallas":
            return dict(kind="stem", frames=x.shape[0] * x.shape[1], es=es,
                        backward=False)
        if (kind == "flash" and mod.use_flash and not mod.causal
                and not tr and kwargs.get("lengths") is not None):
            b, t, d = x.shape
            h = mod.num_heads
            return dict(kind="flash", b=b, h=h, t=t, da=d // h + d + 1,
                        dv=d // h, lengths=kwargs["lengths"].detach().clone(),
                        es=es, backward=False)
        return None

    def remove(self):
        for h in self.handles:
            h.remove()


kernel_calls = KernelCalls
