"""Rematerialized training (`remat=True`) of the port against the plain
step and against the JAX package's `nn.remat` stack, fp32 on the CPU.

* The blocks the port rematerializes are those of the JAX `_block_plan`
  runs of more than one block, for the AV, AO (patch and regular), causal AO
  and VO encoders at reference depth (the plan is plain Python: nothing is
  compiled).
* A small AV model with dropout 0.1, SpecAugment and the three fused routes
  on (their plain versions on the CPU): two `train_step`s with remat give
  losses, gradients, BN buffers, parameters and the state of every
  generator `torch.equal` to two without.
* One `ConformerInterCTC(remat=True)` in training mode (dropout off, batch
  statistics) against the JAX one with `remat=True` on the same weights:
  outputs, InterCTC logits, updated BN statistics and the gradients of the
  parameters and the input within 1e-4.
* Two gloo ranks, data-parallel with sync-BN and the K3dp plain stages:
  remat gives each rank the same losses, gradients and BN buffers as the
  plain step, bit for bit.

JAX is imported inside the tests that compare with it: the ranks import
this module without it.
"""

import numpy as np
import torch

from avec_tpu_torch.parallel import dist as pdist
from avec_tpu_torch.parallel.dist import spawn

torch.set_num_threads(1)

# v: runs [0, 1], [2], [3]; a: [0, 1], [2], [3], [4], [5]; f: [0], [1, 2]
SMALL = dict(vocab_size=32, v_num_blocks=(3, 1), a_num_blocks=(3, 2, 1),
             f_num_blocks=3, v_interctc_blocks=(3,), a_interctc_blocks=(3,),
             f_interctc_blocks=(1,), fused_att=True, fused_conv=True,
             fused_ffn=True, stem_mode="2d")
GEN_ATTRS = ("generator", "seed_generator", "band_generator")


def _batch(seed, b=2):
    rng = np.random.RandomState(seed)
    alen = np.array([5600, 4480, 5120, 4800][:b], np.int32)
    ta = int(alen.max())
    return {"inputs": [rng.rand(b, ta // 640 + 1, 88, 88, 1).astype(np.float32),
                       alen // 640 + 1,
                       (rng.randn(b, ta) * 0.1).astype(np.float32), alen],
            "targets": (rng.randint(1, 32, size=(b, 4)).astype(np.int32),
                        np.array([3, 2, 3, 2][:b], np.int32))}


def _generator_states(model):
    seen, states = set(), []
    for m in model.modules():
        for attr in GEN_ATTRS:
            g = getattr(m, attr, None)
            if isinstance(g, torch.Generator) and id(g) not in seen:
                seen.add(id(g))
                states.append(g.get_state())
    return states


def _two_steps(trainer, batches):
    """(per step: losses and gradients), BN buffers, parameters and the
    generators' states after the steps."""
    steps = []
    for batch in batches:
        losses, _ = trainer.train_step(batch)
        assert torch.isfinite(losses["loss"])
        steps.append(({k: v.clone() for k, v in losses.items()},
                      {n: p.grad.clone()
                       for n, p in trainer.model.named_parameters()}))
    model = trainer.model
    return (steps, {n: b.clone() for n, b in model.named_buffers()},
            {n: p.detach().clone() for n, p in model.named_parameters()},
            _generator_states(model))


def _equal(a, b):
    return set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)


def _assert_same_run(with_remat, without):
    (s1, b1, p1, g1), (s2, b2, p2, g2) = with_remat, without
    for (l1, gr1), (l2, gr2) in zip(s1, s2):
        assert _equal(l1, l2), (l1, l2)
        assert _equal(gr1, gr2), [k for k in gr1
                                  if not torch.equal(gr1[k], gr2[k])][:5]
    assert _equal(b1, b2)
    assert _equal(p1, p2)
    assert len(g1) == len(g2) == 3
    assert all(torch.equal(x, y) for x, y in zip(g1, g2))


def _jax_runs(mod):
    return [[b["index"] for b in run] for run in mod._block_plan()]


def test_remat_blocks_are_the_jax_block_plan_runs():
    """The port's plan and rematerialized set against the JAX
    `_block_plan`, built with the arguments the JAX encoders pass
    (encoders.py:275-284, :312-323, :430-438, :529-538); the flagship AV
    model rematerializes 15 of its 24 blocks (7 video, 12 audio, 5
    fusion)."""
    from avec_tpu.models.conformer import ConformerInterCTC as JaxStack
    from avec_tpu.models.encoders import _att_params_audio
    from avec_tpu_torch.models import encoders as pe

    rel = {"class": "RelPos1dMultiHeadAttention",
           "params": {"num_heads": 4, "attn_drop_rate": 0.0,
                      "num_pos_embeddings": 10000, "weight_init": "default",
                      "bias_init": "default"}}
    xl = {"class": "RelPosMultiHeadSelfAttention",
          "params": {"num_heads": 4, "attn_drop_rate": 0.0,
                     "max_pos_encoding": 10000, "causal": True}}
    common = dict(vocab_size=256, kernel_size=15, ff_ratio=4, drop_rate=0.1,
                  conv_stride=2, batch_norm=True, remat=True)
    audio = dict(dim_model=[180, 256, 360], **common)
    cases = []
    for att_type in ("patch", "regular"):
        for blocks, inter in (((5, 6, 5), (3, 6, 10, 13)),
                              ((5, 6, 1), (8, 11))):
            port = pe.AudioEfficientConformerEncoder(
                att_type=att_type, num_blocks=blocks, interctc_blocks=inter,
                remat=True).back_end
            jax = JaxStack(num_blocks=list(blocks),
                           interctc_blocks=list(inter),
                           att_params=_att_params_audio(
                               att_type, 4, 0.0, 10000, False), **audio)
            cases.append((port, jax))
    port = pe.AudioEfficientConformerEncoder(
        causal=True, left_context=64, remat=True).back_end
    cases.append((port, JaxStack(num_blocks=[5, 6, 5],
                                 interctc_blocks=[3, 6, 10, 13],
                                 att_params=[xl] * 3,
                                 conv_padding="causal", **audio)))
    for blocks, inter in (((6, 6), (3, 6, 9)), ((6, 1), (3, 6))):
        port = pe.VisualEfficientConformerEncoder(
            num_blocks=blocks, interctc_blocks=inter, remat=True).back_end
        cases.append((port, JaxStack(dim_model=[256, 360],
                                     num_blocks=list(blocks),
                                     interctc_blocks=list(inter),
                                     att_params=rel, **common)))
    av = pe.AudioVisualEfficientConformerEncoder(remat=True)
    cases.append((av.audio_visual_encoder,
                  JaxStack(dim_model=360, num_blocks=5, interctc_blocks=[2],
                           att_params=rel, **common)))
    for port, jax in cases:
        runs = _jax_runs(jax)
        assert port.block_plan() == runs
        assert port.remat_blocks == {i for run in runs if len(run) > 1
                                     for i in run}
    stacks = (av.video_encoder.back_end, av.audio_encoder.back_end,
              av.audio_visual_encoder)
    assert [sorted(s.remat_blocks) for s in stacks] == [
        [0, 1, 3, 4], [0, 1, 2, 3, 5, 6, 8, 9], [2, 3, 4]]
    assert [len(s.conformer_blocks) for s in stacks] == [7, 12, 5]


def test_remat_train_steps_are_bit_identical():
    """Two steps with dropout, SpecAugment and the fused routes' plain
    versions: remat changes no bit of the losses, the gradients, the BN
    buffers, the parameters or the three generators' states. The model's
    kernel launch count adds each rematerialized block's fused forwards."""
    from avec_tpu_torch.train.model import Trainer

    batches = [_batch(0), _batch(1)]
    runs = []
    for remat in (True, False):
        trainer = Trainer(device="cpu", precision="float32", seed=0,
                          remat=remat, **SMALL)
        runs.append(_two_steps(trainer, batches))
        if remat:
            counts = trainer.model.kernel_launches_per_step()
            stacks = [m for m in trainer.model.modules()
                      if hasattr(m, "remat_blocks")]
            assert sum(len(s.remat_blocks) for s in stacks) == 6
        else:
            plain = trainer.model.kernel_launches_per_step()
    _assert_same_run(*runs)
    # 6 blocks: 2 FFNs and 1 conv module each, and a fused attention
    # module in the 4 that are not the audio stage 1's patch attention
    assert counts == {**plain,
                      "fused_ffn_fwd": plain["fused_ffn_fwd"] + 12,
                      "fused_att_fwd": plain["fused_att_fwd"] + 4,
                      "fused_conv_stats": plain["fused_conv_stats"] + 6,
                      "fused_conv_fwd": plain["fused_conv_fwd"] + 6}


def test_remat_stack_matches_jax_remat():
    """ConformerInterCTC(remat=True) in training mode with dropout off
    against the JAX stack with remat=True: runs [0, 1], [2], [3, 4], [5]."""
    import jax
    import jax.numpy as jnp

    from avec_tpu.models.conformer import ConformerInterCTC as JaxStack
    from avec_tpu.ops.masks import padding_mask as jax_padding_mask
    from avec_tpu_torch.convert import grads_to_jax_layout, state_to_jax
    from avec_tpu_torch.models.conformer import ConformerInterCTC
    from avec_tpu_torch.ops.masks import padding_mask

    from test_torch_support import init_variables, port_state, t

    att = {"class": "RelPos1dMultiHeadAttention", "params": {"num_heads": 4}}
    kw = dict(dim_model=[16, 24], num_blocks=[3, 3], interctc_blocks=[6],
              vocab_size=8, kernel_size=5, drop_rate=0.0)
    rng = np.random.RandomState(4)
    tt = 12
    x = rng.randn(2, tt, 16).astype(np.float32)
    lengths = np.array([12, 7], np.int32)
    g = rng.randn(2, tt // 2, 24).astype(np.float32)
    gl = rng.randn(2, tt // 2, 8).astype(np.float32)
    mask = jax_padding_mask(jnp.asarray(lengths), tt)
    jmod = JaxStack(att_params=att, remat=True, **kw)
    params, stats = init_variables(jmod, x, jnp.asarray(lengths), mask,
                                   seed=5)
    assert sorted(k for k in params if k.startswith("block")) == [
        "block_2", "block_5", "blocks_0_1", "blocks_3_4"]

    def loss(p, xx):
        (y, _, inter), new = jmod.apply(
            {"params": p, "batch_stats": stats}, xx, jnp.asarray(lengths),
            mask, deterministic=False, mutable=["batch_stats"])
        return (jnp.sum(y * g) + jnp.sum(inter["ctc_5"][0] * gl),
                (y, inter["ctc_5"][0], new["batch_stats"]))

    (_, (want_y, want_l, want_stats)), (want_gp, want_gx) = \
        jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
            params, jnp.asarray(x))

    port = ConformerInterCTC(att_params=att, remat=True, fused_att=False,
                             fused_conv=False, fused_ffn=False, **kw)
    port.load_state_dict(port_state(params, stats))
    assert port.remat_blocks == {0, 1, 3, 4}
    port.train()
    xt = t(x).requires_grad_(True)
    y, _, inter = port(xt, t(lengths), padding_mask(t(lengths), tt))
    (torch.sum(y * t(g)) + torch.sum(inter["ctc_5"][0] * t(gl))).backward()
    close = lambda got, want: np.testing.assert_allclose(
        np.asarray(got), np.asarray(want), rtol=0, atol=1e-4)
    close(y.detach().numpy(), want_y)
    close(inter["ctc_5"][0].detach().numpy(), want_l)
    close(xt.grad.numpy(), want_gx)
    # a detached depthwise bias has no gradient; JAX's is an exact zero
    grads = grads_to_jax_layout(
        {n: torch.zeros_like(p) if p.grad is None else p.grad
         for n, p in port.named_parameters()}, params)
    got_stats = state_to_jax(port.state_dict(), params, stats)[1]
    for got, want in ((grads, want_gp), (got_stats, want_stats)):
        flat_got = jax.tree_util.tree_leaves_with_path(got)
        flat_want = dict(jax.tree_util.tree_leaves_with_path(want))
        assert len(flat_got) == len(flat_want)
        for path, leaf in flat_got:
            close(leaf, flat_want[path])


def remat_dp_rank(device, model_kwargs, batches):
    """Both steps twice on this rank's shards, data-parallel, with and
    without remat: whether the runs are bit-identical, and a digest of the
    parameters."""
    from avec_tpu_torch.train.model import Trainer

    torch.set_num_threads(1)
    shards = [pdist.shard_batch(b) for b in batches]
    runs = []
    for remat in (True, False):
        trainer = Trainer(device="cpu", precision="float32", seed=0,
                          data_parallel=True, remat=remat, **model_kwargs)
        runs.append(_two_steps(trainer, shards))
    try:
        _assert_same_run(*runs)
        same = True
    except AssertionError:
        same = False
    return {"same": same,
            "losses": [float(s[0]["loss"]) for s in runs[0][0]],
            "params": [float(p.double().sum()) for p in runs[0][2].values()]}


def test_remat_data_parallel_matches_plain():
    """Two gloo ranks (sync-BN, K3dp plain stages, per-rank seeds): each
    rank's remat run equals its plain run bit for bit, and the ranks agree
    on the losses and the parameters."""
    batches = [_batch(0, 4), _batch(1, 4)]
    ranks = spawn(remat_dp_rank, 2, "gloo", "cpu", SMALL, batches)
    assert all(r["same"] for r in ranks)
    assert ranks[0]["losses"] == ranks[1]["losses"]
    assert ranks[0]["params"] == ranks[1]["params"]
