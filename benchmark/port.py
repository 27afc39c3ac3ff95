"""The program under test, built from a configuration file: the port's zoo
model with the route the configuration states for training or serving,
seeded weights from the benchmark loaded into it, and its `Trainer` or
`Server`. This is the only file that constructs the program."""

import gc
from typing import Dict, Tuple

import torch

from benchmark import weights


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


def server(model, serve: dict, kind: str, device):
    from avec_tpu_torch.serve import Server

    return Server(model=model.eval(), device=device,
                  precision=serve["precision"], mode=kind)


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


def release() -> None:
    """Return the memory of the program's dropped objects to the card."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
