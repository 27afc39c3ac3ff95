"""Plain fp32 reference of the audio-visual and audio-only Efficient
Conformer InterCTC (Burchim et al., "Audio-Visual Efficient Conformer for
Robust Speech Recognition", WACV 2023), forward and training step.

Written from the published architecture in plain `torch` operations, with
no kernel, cache or batching of the program under test, and importing
nothing of it. Parameters are one flat dict keyed by the state-dict names
the benchmark generates, so the same weights load into both sides.

Where the trained model draws random numbers, the reference draws the same
ones from generators seeded alike, through frozen copies of the rules:
inverted dropout from a device generator (`torch.rand(shape) < keep`),
SpecAugment's bands and time masks, and the counter-hash dropout masks of
the fused feed-forward, attention and convolution modules, whose 31-bit
seeds come from a CPU generator, one per module call in forward order.

`fp8=True` is the control: every operand of a product (linear layers,
convolutions, attention scores and values) is rounded to float8 e4m3 with
a per-tensor scale in the forward, the step below the bfloat16 the
configurations state.
"""

import math
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

NEG = -1e9
DROP = 0.1
BN_EPS = 1e-5
LN_EPS = 1e-6
_SEED_STRIDE = 1103515245
_GOLDEN = 0x9E3779B9
_M32 = 0xFFFFFFFF


# ----------------------------------------------------------------- context
class Ctx:
    """What one forward needs besides the parameters: the mode, the
    generators (noise on the device, seeds on the CPU, bands on the device)
    and the control's rounding."""

    def __init__(self, train: bool, seed: Optional[int] = None, device=None,
                 fp8: bool = False):
        self.train = train
        self.fp8 = fp8
        if train:
            self.noise = torch.Generator(device=device).manual_seed(seed)
            self.seeds = torch.Generator().manual_seed(seed + 1)
            self.bands = torch.Generator(device=device).manual_seed(seed + 2)

    def q(self, x):
        """An operand of a product: itself, or rounded to e4m3 (control)."""
        if not self.fp8:
            return x
        scale = x.detach().abs().amax().clamp(min=1e-30) / 448.0
        r = (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale
        return x + (r - x.detach())

    def draw_seed(self) -> int:
        return int(torch.randint(0, 2 ** 31, (), generator=self.seeds))


def _mix32(x):
    x = x ^ (x >> 16)
    x = (x * 0x85EBCA6B) & _M32
    x = x ^ (x >> 13)
    x = (x * 0xC2B2AE35) & _M32
    return x ^ (x >> 16)


def hash_keep(seed: int, n: int, ncols: int, draw: int, tile: int, device):
    """(n, ncols) multipliers 0 or 1/keep of the counter hash: key of the
    row's tile and the draw, murmur3 of (row in tile * ncols + col) ^ key."""
    keep = 1.0 - DROP
    thr = min(int(keep * float(2 ** 32)), 2 ** 32 - 1)
    rows = torch.arange(n, dtype=torch.int64, device=device)
    cols = torch.arange(ncols, dtype=torch.int64, device=device)
    base = (int(seed) + (rows // tile) * _SEED_STRIDE) & _M32
    key = _mix32((base + (draw * _GOLDEN) % (2 ** 32)) & _M32)
    flat = (((rows % tile) * ncols)[:, None] + cols[None, :]) & _M32
    bits = _mix32(flat ^ key[:, None])
    return (bits < thr).float() * float(np.float32(1.0 / keep))


def dropout(ctx: Ctx, x):
    if not ctx.train:
        return x
    keep = 1.0 - DROP
    m = torch.rand(x.shape, generator=ctx.noise, device=x.device) < keep
    return torch.where(m, x / keep, torch.zeros((), device=x.device))


# ------------------------------------------------------------------ layers
def linear(ctx, P, name, x):
    return F.linear(ctx.q(x), ctx.q(P[name + ".weight"]), P[name + ".bias"])


def layer_norm(P, name, x, eps=LN_EPS):
    return F.layer_norm(x, (x.shape[-1],), P[name + ".weight"],
                        P[name + ".bias"], eps)


def batch_norm(ctx, P, B, name, x):
    """Channels on axis 1; batch statistics in training (biased variance),
    running ones in eval."""
    if ctx.train:
        axes = [0] + list(range(2, x.ndim))
        mean = x.mean(dim=axes, keepdim=True)
        var = ((x - mean) ** 2).mean(dim=axes, keepdim=True)
    else:
        shape = (1, -1) + (1,) * (x.ndim - 2)
        mean = B[name + ".running_mean"].view(shape)
        var = B[name + ".running_var"].view(shape)
    shape = (1, -1) + (1,) * (x.ndim - 2)
    return ((x - mean) / torch.sqrt(var + BN_EPS) * P[name + ".weight"]
            .view(shape) + P[name + ".bias"].view(shape))


def swish(x):
    return x * torch.sigmoid(x)


def key_mask(lengths, t):
    """(B, 1, 1, T): True where a key is inside its sequence."""
    return (torch.arange(t, device=lengths.device)[None, :]
            < lengths[:, None])[:, None, None, :]


def restride(lengths, s):
    return torch.div(lengths - 1, s, rounding_mode="floor") + 1


# ------------------------------------------------------------- attention
def rel_pos_attention(ctx, P, name, x, mask, heads=4):
    """Multi-head self-attention with sinusoidal relative positions: the
    score of query i and key j adds q_i . W_pos PE(i - j) (+ b_pos), where
    PE(r) interleaves sin(r w_m) and cos(r w_m), w_m = 10000^(-2m / D)."""
    b, t, d = x.shape
    dh = d // heads
    split = lambda a: a.reshape(b, t, heads, dh).transpose(1, 2)
    q = split(linear(ctx, P, name + ".query_layer", x))
    k = split(linear(ctx, P, name + ".key_layer", x))
    v = split(linear(ctx, P, name + ".value_layer", x))
    rel = torch.arange(t - 1, -t, -1, device=x.device, dtype=torch.float64)
    w = 1.0 / 10000.0 ** (2.0 * torch.arange(d // 2, device=x.device,
                                             dtype=torch.float64) / d)
    ang = rel[:, None] * w[None, :]
    pe = torch.stack([torch.sin(ang), torch.cos(ang)], dim=-1).reshape(
        2 * t - 1, d).float()
    e = linear(ctx, P, name + ".pos_layer", pe)           # (2T-1, D)
    e = e.reshape(2 * t - 1, heads, dh).transpose(0, 1)    # (H, 2T-1, dh)
    s_e = torch.einsum("bhid,hrd->bhir", ctx.q(q), ctx.q(e))
    # column r of s_e holds distance (t - 1 - r); (i, j) needs i - j
    idx = (t - 1 - (torch.arange(t, device=x.device)[:, None]
                    - torch.arange(t, device=x.device)[None, :]))
    s_e = torch.gather(s_e, 3, idx[None, None].expand(b, heads, t, t))
    s = torch.einsum("bhid,bhjd->bhij", ctx.q(q), ctx.q(k))
    s = (s + s_e) / math.sqrt(dh)
    if mask is not None:
        s = s + (~mask).float() * NEG
    a = torch.softmax(s, dim=-1)
    o = torch.einsum("bhij,bhjd->bhid", ctx.q(a), ctx.q(v))
    o = o.transpose(1, 2).reshape(b, t, d)
    return linear(ctx, P, name + ".output_layer", o)


def patch_attention(ctx, P, name, x, lengths, patch=3):
    """Attention over averages of `patch` frames (a patch is valid when all
    its frames are), repeated back to frames and cut to T."""
    b, t, d = x.shape
    pad = (-t) % patch
    xp = F.pad(x, (0, 0, 0, pad))
    valid = (torch.arange(t + pad, device=x.device)[None, :]
             < lengths[:, None])
    pv = valid.reshape(b, -1, patch).all(dim=-1)           # (B, T')
    xa = xp.reshape(b, -1, patch, d).mean(dim=2)
    o = rel_pos_attention(ctx, P, name, xa, pv[:, None, None, :])
    return o.repeat_interleave(patch, dim=1)[:, :t]


# ---------------------------------------------------------------- modules
def ffn(ctx, P, name, x):
    """LN -> Linear(4D) -> swish -> dropout -> Linear(D) -> dropout; in
    training the fused module's hash masks over the flattened rows (tiles of
    256 rows; draw 1 inner, draw 2 outer)."""
    h = layer_norm(P, name + ".layers.0", x)
    u = swish(linear(ctx, P, name + ".layers.1", h))
    if ctx.train:
        seed = ctx.draw_seed()
        b, t, d = x.shape
        f = u.shape[-1]
        u = u * hash_keep(seed, b * t, f, 1, 256, x.device).view(b, t, f)
        y = linear(ctx, P, name + ".layers.4", u)
        return y * hash_keep(seed, b * t, d, 2, 256, x.device).view(b, t, d)
    return linear(ctx, P, name + ".layers.4", u)


def attention_module(ctx, P, name, x, lengths, kind):
    h = layer_norm(P, name + ".norm", x)
    att = name + ".attention"
    if kind == "patch":
        return dropout(ctx, patch_attention(ctx, P, att, h, lengths))
    y = rel_pos_attention(ctx, P, att, h, key_mask(lengths, x.shape[1]))
    if ctx.train:                       # the fused module: one tile a row
        b, t, d = x.shape
        seed = ctx.draw_seed()
        return y * hash_keep(seed, b * t, d, 1, t, x.device).view(b, t, d)
    return y


def conv1d(ctx, P, name, x, stride=1, pad=(0, 0), groups=1, bias=True):
    x = F.pad(x, pad)
    return F.conv1d(ctx.q(x), ctx.q(P[name + ".weight"]),
                    P[name + ".bias"] if bias else None, stride=stride,
                    groups=groups)


def conv_module(ctx, P, B, name, x, stride, k=15):
    """LN -> pointwise 2E -> GLU -> depthwise k (stride) -> BN -> swish ->
    pointwise -> dropout; the hash mask in training at stride 1 (the fused
    module), inverted dropout otherwise."""
    lay = name + ".layers"
    h = layer_norm(P, lay + ".0", x).transpose(1, 2)
    h = conv1d(ctx, P, lay + ".1", h)
    e = h.shape[1] // 2
    h = h[:, :e] * torch.sigmoid(h[:, e:])
    dw = P[lay + ".3.weight"]
    h = F.conv1d(F.pad(ctx.q(h), ((k - 1) // 2, k // 2)), ctx.q(dw),
                 P[lay + ".3.bias"], stride=stride, groups=dw.shape[0])
    h = swish(batch_norm(ctx, P, B, lay + ".4", h))
    y = conv1d(ctx, P, lay + ".6", h).transpose(1, 2)
    if ctx.train and stride == 1:
        seed = ctx.draw_seed()
        b, t, eo = y.shape
        return y * hash_keep(seed, b * t, eo, 1, t, x.device).view(b, t, eo)
    return dropout(ctx, y)


def conformer_block(ctx, P, B, name, x, lengths, kind, stride):
    x = x + 0.5 * ffn(ctx, P, name + ".ff_module1", x)
    x = x + attention_module(ctx, P, name + ".self_att_module", x, lengths,
                             kind)
    conv_out = conv_module(ctx, P, B, name + ".conv_module", x, stride)
    if name + ".conv_res.weight" in P:
        res = conv1d(ctx, P, name + ".conv_res", x.transpose(1, 2),
                     stride=stride).transpose(1, 2)
    else:
        res = x[:, ::stride]
    x = res + conv_out
    x = x + 0.5 * ffn(ctx, P, name + ".ff_module2", x)
    return layer_norm(P, name + ".norm", x)


def conformer_stack(ctx, P, B, name, x, lengths, num_blocks, interctc,
                    kinds, prefix):
    """Stages of blocks; the last block of each stage but the last strides
    by 2. InterCTC after block i (1-based in `interctc`): logits =
    proj_1(x), x += proj_2(softmax(logits))."""
    outputs = {}
    x = dropout(ctx, x)
    i, inter = 0, 0
    for stage, n in enumerate(num_blocks):
        for j in range(n):
            stride = 2 if (j == n - 1 and stage < len(num_blocks) - 1) else 1
            x = conformer_block(ctx, P, B, f"{name}.conformer_blocks.{i}", x,
                                lengths, kinds[stage], stride)
            logits = None
            if i + 1 in interctc:
                m = f"{name}.interctc_modules.{inter}"
                logits = linear(ctx, P, m + ".proj_1", x)
                x = x + linear(ctx, P, m + ".proj_2",
                               torch.softmax(logits, dim=-1))
                inter += 1
            if stride > 1:
                lengths = restride(lengths, stride)
            if logits is not None:
                outputs[f"{prefix}_{i}"] = (logits, lengths)
            i += 1
    return x, lengths, outputs


# ---------------------------------------------------------------- front ends
def _hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + f / 700.0)


def mel_matrix(n_freqs=257, n_mels=80, sr=16000, f_max=8000.0):
    """HTK triangular filters without normalisation, (n_freqs, n_mels)."""
    freqs = np.linspace(0.0, sr / 2.0, n_freqs)
    mels = np.linspace(_hz_to_mel(0.0), _hz_to_mel(f_max), n_mels + 2)
    pts = 700.0 * (10.0 ** (mels / 2595.0) - 1.0)
    fb = np.zeros((n_freqs, n_mels))
    for m in range(n_mels):
        lo, c, hi = pts[m], pts[m + 1], pts[m + 2]
        rise = (freqs - lo) / (c - lo)
        fall = (hi - freqs) / (hi - c)
        fb[:, m] = np.maximum(0.0, np.minimum(rise, fall))
    return torch.from_numpy(fb.astype(np.float32))


def fbank(audio, lengths):
    """16 kHz audio (B, T) -> log-mels (B, 80, T // 160 + 1): |rFFT|^2 of
    512-sample frames every 160 samples, reflect-padded by 256, a periodic
    400-sample Hann window centred in the frame; 80 HTK mels to 8 kHz;
    log(x + 1e-9)."""
    n = audio.shape[1] // 160 + 1
    xp = F.pad(audio[:, None], (256, 256), mode="reflect")[:, 0]
    frames = xp.unfold(-1, 512, 160)[:, :n]
    win = torch.zeros(512, device=audio.device, dtype=torch.float64)
    win[56:456] = torch.hann_window(400, periodic=True, dtype=torch.float64,
                                    device=audio.device)
    spec = torch.fft.rfft(frames * win.float(), n=512).abs() ** 2
    mel = spec @ mel_matrix().to(audio.device)
    return (torch.log(mel + 1e-9).transpose(1, 2),
            torch.div(lengths, 160, rounding_mode="floor") + 1)


def spec_augment(ctx, x, lengths, mF=2, Fw=27, mT=5, pS=0.05):
    """Frequency bands shared by the batch (from the band generator) and
    adaptive time masks per utterance inside its frames (from the noise
    generator), drawn in that order; masked entries are 0."""
    if not ctx.train:
        return x
    b, n_mels, t = x.shape
    dev = x.device
    keep = torch.ones((b, n_mels, t), dtype=torch.bool, device=dev)
    freq = torch.arange(n_mels, device=dev)
    for _ in range(mF):
        width = (torch.rand((), generator=ctx.bands, device=dev)
                 * (Fw + 1)).long()
        room = torch.clamp(n_mels - width, min=0)
        start = (torch.rand((), generator=ctx.bands, device=dev)
                 * (room + 1).float()).long()
        keep &= ~((freq >= start) & (freq < start + width))[None, :, None]
    time = torch.arange(t, device=dev)[None, :]
    lens = lengths.long()
    max_width = (pS * lens.float()).long()
    for _ in range(mT):
        width = (torch.rand((b,), generator=ctx.noise, device=dev)
                 * (max_width + 1).float()).long()
        room = torch.clamp(lens - width, min=0)
        start = (torch.rand((b,), generator=ctx.noise, device=dev)
                 * (room + 1).float()).long()
        tm = ((time >= start[:, None]) & (time < (start + width)[:, None])
              & (time < lens[:, None]))
        keep &= ~tm[:, None, :]
    return torch.where(keep, x, torch.zeros((), device=dev))


def conv2d(ctx, P, name, x, stride, pad, bias=True):
    return F.conv2d(F.pad(ctx.q(x), pad), ctx.q(P[name + ".weight"]),
                    P[name + ".bias"] if bias else None, stride=stride)


def audio_encoder(ctx, P, B, name, audio, lengths, spec, prefix):
    x, lengths = fbank(audio, lengths)
    x = spec_augment(ctx, x, lengths)
    sub = name + ".subsampling_module.layers.0"
    x = conv2d(ctx, P, sub + ".0", x[:, None], 2, (1, 1, 1, 1))
    x = swish(batch_norm(ctx, P, B, sub + ".1", x))
    lengths = restride(lengths, 2)
    b, c, f, t = x.shape
    x = linear(ctx, P, name + ".linear",
               x.permute(0, 3, 1, 2).reshape(b, t, c * f))
    kinds = ["patch" if spec["att_type"] == "patch" else "regular",
             "regular", "regular"]
    return conformer_stack(ctx, P, B, name + ".back_end", x, lengths,
                           spec["a_num_blocks"], spec["a_interctc_blocks"],
                           kinds, prefix)


def resnet18(ctx, P, B, name, x):
    """Basic blocks (64, 128, 256, 512) x 2 without the stem; 3x3 convs
    padded by 1, a strided 1x1 conv + BN on a changed shortcut; global
    average pool and the linear head."""
    i = 0
    for stage, dim in enumerate((64, 128, 256, 512)):
        for j in range(2):
            s = 2 if (j == 0 and stage > 0) else 1
            blk = f"{name}.blocks.{i}"
            y = conv2d(ctx, P, blk + ".layers.0", x, s, (1, 1, 1, 1), False)
            y = torch.relu(batch_norm(ctx, P, B, blk + ".layers.1", y))
            y = conv2d(ctx, P, blk + ".layers.3", y, 1, (1, 1, 1, 1), False)
            y = batch_norm(ctx, P, B, blk + ".layers.4", y)
            if blk + ".residual.0.weight" in P:
                r = conv2d(ctx, P, blk + ".residual.0", x, s, (0, 0, 0, 0),
                           False)
                r = batch_norm(ctx, P, B, blk + ".residual.1", r)
            else:
                r = x
            x = torch.relu(y + r)
            i += 1
    return linear(ctx, P, name + ".head.1", x.mean(dim=(2, 3)))


def video_encoder(ctx, P, B, name, video, lengths, spec, prefix):
    """(B, T, 88, 88, 1) frames: Conv3d 1->64 (5, 7, 7) stride (1, 2, 2)
    padded (2, 3, 3), BN, ReLU, 3x3/2 max pool padded by 1; ResNet-18 per
    frame to 256; two conformer stages."""
    b, t = video.shape[:2]
    stem = name + ".front_end.0.layers.0"
    x = video.permute(0, 4, 1, 2, 3)
    x = F.conv3d(ctx.q(x), ctx.q(P[stem + ".0.weight"]), P[stem + ".0.bias"],
                 stride=(1, 2, 2), padding=(2, 3, 3))
    x = x.transpose(1, 2).reshape(b * t, 64, 44, 44)
    x = torch.relu(batch_norm(ctx, P, B, stem + ".1", x))
    x = F.max_pool2d(x, 3, 2, padding=1)
    x = resnet18(ctx, P, B, name + ".front_end.3", x).reshape(b, t, -1)
    return conformer_stack(ctx, P, B, name + ".back_end", x, lengths,
                           spec["v_num_blocks"], spec["v_interctc_blocks"],
                           ["regular", "regular"], prefix)


def forward(ctx: Ctx, P: Dict[str, torch.Tensor], B: Dict[str, torch.Tensor],
            spec: dict, inputs: List[torch.Tensor]):
    """The model's outputs {name: (logits, lengths)}: "outputs" and the
    InterCTC heads. `inputs` as the model takes them: [video, video_len,
    audio, audio_len] (audio-visual) or [audio, audio_len] (audio-only)."""
    if spec["kind"] == "ao":
        audio, alen = inputs
        x, lengths, inter = audio_encoder(ctx, P, B, "encoder", audio, alen,
                                          spec, "ctc")
        return {"outputs": (linear(ctx, P, "encoder.head", x), lengths),
                **inter}
    video, vlen, audio, alen = inputs
    v, _, v_inter = video_encoder(ctx, P, B, "encoder.video_encoder", video,
                                  vlen, spec, "v_ctc")
    a, lengths, a_inter = audio_encoder(ctx, P, B, "encoder.audio_encoder",
                                        audio, alen, spec, "a_ctc")
    ta = a.shape[1]
    if v.shape[1] < ta:
        v = F.pad(v, (0, 0, 0, ta - v.shape[1]))
    v = v[:, :ta]
    x = linear(ctx, P, "encoder.fusion_module.layers.0",
               torch.cat([a, v], dim=-1))
    x = linear(ctx, P, "encoder.fusion_module.layers.2", swish(x))
    x, lengths, f_inter = conformer_stack(
        ctx, P, B, "encoder.audio_visual_encoder", x, lengths,
        [spec["f_num_blocks"]], spec["f_interctc_blocks"], ["regular"],
        "f_ctc")
    return {"outputs": (linear(ctx, P, "encoder.head", x), lengths),
            **f_inter, **v_inter, **a_inter}
