"""A toy family, a fixture of the harness's tests and never listed: a
two-layer CTC encoder over the port's log-mel filterbank. Frames are
stacked `stack` at a time, then two linear layers with ReLU and a linear
head. It is trained through the port's `Trainer`, is not served, and
launches no hand-written kernel."""

import torch
from torch import nn

from benchmark import data, weights
from benchmark.reference.toy import forward as reference_forward  # noqa


class ToyCTC(nn.Module):
    def __init__(self, spec: dict):
        from avec_tpu_torch.ops.audio import AudioPreprocessing

        super().__init__()
        d, self.stack = spec["dim"], spec["stack"]
        self.fbank = AudioPreprocessing()
        self.layers = nn.ModuleList([nn.Linear(80 * self.stack, d),
                                     nn.Linear(d, d)])
        self.head = nn.Linear(d, spec["vocab_size"])

    def set_generators(self, seed: int) -> None:
        """No dropout: nothing to seed."""

    def compile_defaults(self) -> dict:
        from avec_tpu_torch.train.losses import CTCLoss

        return {"loss": CTCLoss(), "loss_weights": {"outputs": 1.0},
                "metrics": None}

    def forward(self, audio, audio_len):
        x, lengths = self.fbank(audio.float(), audio_len)
        b, _, t = x.shape
        s = self.stack
        x = nn.functional.pad(x.transpose(1, 2), (0, 0, 0, -t % s))
        x = x.reshape(b, -1, 80 * s)
        for layer in self.layers:
            x = torch.relu(layer(x))
        return {"outputs": [self.head(x),
                            torch.div(lengths - 1, s, rounding_mode="floor")
                            + 1]}


def build_model(spec, route, seed, device):
    model = ToyCTC(spec).to(device)
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    state = weights.make_state(shapes, seed, device)
    model.load_state_dict(state, strict=True)
    return model, state


def trainer(model, train, seed, device):
    from avec_tpu_torch.train.losses import CTCLoss
    from avec_tpu_torch.train.model import Trainer

    return Trainer(model=model, device=device, precision=train["precision"],
                   seed=seed, loss=CTCLoss(zero_infinity=True,
                                           assert_shorter=False),
                   loss_weights=dict(train["loss_weights"]), metrics=None)


def train_batch(spec, samples, traffic, seed, device):
    labels, u = data.labels(samples, traffic, seed)
    return {"inputs": [data.audio(samples, seed, device),
                       torch.as_tensor(samples, dtype=torch.int32,
                                       device=device)],
            "targets": (torch.as_tensor(labels, device=device),
                        torch.as_tensor(u, device=device))}


def forward_flops(spec, batch, samples, frames=0):
    """The mel filterbank's product and the three linear layers."""
    t = samples // 160 + 1
    s, d = spec["stack"], spec["dim"]
    ts = -(-t // s)
    return 2.0 * batch * (t * 257 * 80 + ts * d * (80 * s + d
                                                   + spec["vocab_size"]))


class _NoCalls:
    """The toy model launches no hand-written kernel."""

    def __init__(self, model, training: bool):
        self.calls, self.active = [], False

    def remove(self):
        pass


kernel_calls = _NoCalls
