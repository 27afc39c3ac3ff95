"""The port's GPT and its training parts against the JAX package's: GPT-Tiny
(avec_tpu_torch/models/transformer.py, zoo.GPT) on the same weights, a train
step, attention dropout, AdamW with the GPT decay mask, the cosine
schedule, CorpusLM, the state_dict converter, the GPT rescorer of
`CTCBeamSearchDecoder`, and the feed-forward gate that keeps a GELU FFN off
the fused kernel.

Tolerances: logits 1e-4; the train step's loss 1e-5 relative and every
gradient leaf 1e-4 of its largest entry; AdamW's parameters and moments
1e-6 of the leaf's scale; neural scores 1e-4.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avec_tpu.data.collate import CollateFn as JaxCollateFn
from avec_tpu.data.corpus_lm import CorpusLM as JaxCorpusLM
from avec_tpu.data.loader import DataLoader as JaxLoader
from avec_tpu.decode.beam import CTCBeamSearchDecoder as JaxBeamDecoder
from avec_tpu.models.transformer import GPTNet as JaxGPTNet
from avec_tpu.train import checkpoint as jckpt
from avec_tpu.train.losses import SoftmaxCrossEntropy as JaxCE
from avec_tpu.train.optim import AdamW as JaxAdamW
from avec_tpu.train.optim import gpt_decay_mask as jax_decay_mask
from avec_tpu.train.schedulers import CosineAnnealingScheduler as JaxCosine
from avec_tpu.train.torch_convert import convert_state_dict
from avec_tpu.utils.tokenizer import Tokenizer, train_bpe
from avec_tpu_torch.configs import lm_tone
from avec_tpu_torch.convert import grads_to_jax_layout, params_from_jax
from avec_tpu_torch.data.collate import CollateFn
from avec_tpu_torch.data.corpus_lm import CorpusLM
from avec_tpu_torch.data.loader import DataLoader
from avec_tpu_torch.decode.beam import CTCBeamSearchDecoder
from avec_tpu_torch.models.conformer import FeedForwardModule
from avec_tpu_torch.models.zoo import GPT, AudioVisualEfficientConformerInterCTC
from avec_tpu_torch.ops import _cuda
from avec_tpu_torch.ops.attention import MultiHeadAttention
from avec_tpu_torch.train.checkpoint import save_checkpoint
from avec_tpu_torch.train.losses import SoftmaxCrossEntropy
from avec_tpu_torch.train.optim import AdamW, gpt_decay_mask
from avec_tpu_torch.train.schedulers import CosineAnnealingScheduler

from test_torch_support import init_variables

torch.set_num_threads(1)

VOCAB = 34
TINY = dict(vocab_size=VOCAB, padding_idx=0, max_pos_encoding=64,
            model="GPT-Tiny")


def _ids(seed=0, b=3, length=11):
    rng = np.random.RandomState(seed)
    ids = rng.randint(1, VOCAB, (b, length)).astype(np.int32)
    ids[1, 7:] = 0                       # a padded row
    ids[0, 2] = 0                        # the pad id inside a sequence
    targets = np.roll(ids, -1, axis=1)
    targets[:, -1] = -1
    targets[1, 6:] = -1
    return ids, targets


def _pair(pos_embedding="sin", drop_rate=0.1, seed=0):
    """The JAX GPTNet's seeded variables and the port's GPT with them."""
    net = JaxGPTNet(pos_embedding=pos_embedding, drop_rate=drop_rate, **TINY)
    params, _ = init_variables(net, _ids()[0], training=False, seed=seed)
    if pos_embedding == "learned":        # zeros at init: draw a table
        params["transformer"]["PosEmbedding1d_0"]["pos_encoding"] = (
            np.random.RandomState(seed + 1).randn(64, 64) * 0.1
        ).astype(np.float32)
    model = GPT(pos_embedding=pos_embedding, drop_rate=drop_rate,
                device="cpu", **TINY)
    model.load_state_dict(params_from_jax(params), strict=True)
    return net, params, model


@pytest.mark.parametrize("pos_embedding", ["sin", "learned"])
def test_gpt_tiny_eval_logits_match_jax(pos_embedding):
    net, params, model = _pair(pos_embedding)
    ids, _ = _ids()
    want = np.asarray(net.apply({"params": params}, ids, training=False))
    got = model(torch.from_numpy(ids).long())["output"]
    assert got.shape == (3, 11, VOCAB) and not got.requires_grad
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


def test_gpt_train_step_gradients_match_jax():
    """Dropout 0 on both sides: the cross-entropy and every gradient leaf
    (the key projection's bias has an analytically zero gradient, rounding
    noise around 1e-9 in both packages: a leaf's scale is at least 1e-4);
    the pad row of the embedding takes its gradient as the JAX gather
    gives it (no padding_idx masking)."""
    net, params, model = _pair("learned", drop_rate=0.0)
    ids, targets = _ids(1)

    def loss_fn(p):
        logits = net.apply({"params": p}, ids, training=True,
                           rngs={"dropout": jax.random.PRNGKey(0)})
        return JaxCE(transpose_logits=True)(targets, logits)

    want_loss, want_grads = jax.value_and_grad(loss_fn)(params)
    model.train()
    loss = SoftmaxCrossEntropy(transpose_logits=True)(
        torch.from_numpy(targets).long(),
        model(torch.from_numpy(ids).long())["output"])
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(want_loss), rel=1e-5)
    got = grads_to_jax_layout({n: p.grad for n, p in model.named_parameters()},
                              params)
    flat_w = jax.tree_util.tree_flatten_with_path(want_grads)[0]
    flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    for path, w in flat_w:
        g, w = np.asarray(flat_g[path]), np.asarray(w)
        scale = max(float(np.abs(w).max()), 1e-4)
        assert np.abs(g - w).max() <= 1e-4 * scale, path
    pad = model.embedding.weight.grad[0].numpy()
    want_pad = np.asarray(want_grads["embedding"]["embedding"][0])
    assert np.abs(want_pad).max() > 0
    np.testing.assert_allclose(pad, want_pad, rtol=0,
                               atol=1e-4 * np.abs(want_pad).max())


def test_attention_dropout_keep_rate():
    """MHA's attention dropout in training mode: entries kept at rate 0.9,
    scaled by 1 / 0.9, drawn from the model's generator (a seed gives the
    same output); off in eval."""
    mha = MultiHeadAttention(16, 2, attn_drop_rate=0.1)
    gen = torch.Generator().manual_seed(0)
    for p in mha.parameters():
        p.data.normal_(0, 0.3, generator=gen)
    x = torch.randn(4, 64, 16, generator=gen)
    seen = {}
    mha.dropout.register_forward_hook(
        lambda m, i, o: seen.update(att=i[0], out=o))
    mha.train()
    mha.dropout.training = True
    mha.dropout.generator = torch.Generator().manual_seed(3)
    a = mha(x)
    att, out = seen["att"], seen["out"]
    kept = out != 0
    assert 0.88 < float(kept.float().mean()) < 0.92
    torch.testing.assert_close(out[kept], att[kept] / 0.9)
    mha.dropout.generator = torch.Generator().manual_seed(3)
    assert torch.equal(mha(x), a)
    mha.eval()
    mha.dropout.training = False
    assert torch.equal(mha(x), mha(x))
    model = GPT(device="cpu", **TINY)
    model.set_generators(5)
    drops = [m for m in model.modules()
             if isinstance(m, MultiHeadAttention)]
    assert drops and all(m.dropout.generator is drops[0].dropout.generator
                         for m in drops)


def test_adamw_step_matches_jax_on_the_same_gradients():
    """Three AdamW steps under a cosine schedule (warmup 2) with the GPT
    decay mask, on the same seeded gradients: parameters and both moments
    entry by entry; the mask decays the Linear weights only."""
    _, params, model = _pair("learned")
    sched = dict(warmup_steps=2, val_max=6e-4, val_min=6e-5, end_step=10)
    opt = AdamW(lr=CosineAnnealingScheduler(**sched), betas=(0.9, 0.95),
                eps=1e-8, weight_decay=0.1, decay_mask=gpt_decay_mask)(model)
    jopt = JaxAdamW(lr=JaxCosine(**sched), betas=(0.9, 0.95), eps=1e-8,
                    weight_decay=0.1, decay_mask=jax_decay_mask)
    mask = gpt_decay_mask(model)
    assert {n for n, d in mask.items() if d} == {
        n for n, _ in model.named_parameters()
        if re.search(r"(_layer|ff_module\.layers\.[14]|^head)\.weight$", n)}
    jparams = jax.tree.map(jnp.asarray, params)
    state = jopt.init(jparams)
    rng = np.random.RandomState(7)
    for step in range(3):
        grads = {n: torch.from_numpy(rng.randn(*p.shape).astype(np.float32))
                 for n, p in model.named_parameters()}
        for n, p in model.named_parameters():
            p.grad = grads[n].clone()
        lr = opt.update(step)
        assert lr == pytest.approx(JaxCosine(**sched)(step + 1))
        updates, state = jopt.update(grads_to_jax_layout(grads, params),
                                     state, jparams, step)
        jparams = jax.tree.map(jnp.add, jparams, updates)
    got = grads_to_jax_layout(dict(model.named_parameters()), params)
    names = {id(p): n for n, p in model.named_parameters()}
    moments = {k: grads_to_jax_layout(
        {names[id(p)]: st[k] for p, st in opt.optimizer.state.items()},
        params) for k in ("exp_avg", "exp_avg_sq")}
    adam_state = state[0]
    for want_tree, got_tree in ((jparams, got),
                                (adam_state.mu, moments["exp_avg"]),
                                (adam_state.nu, moments["exp_avg_sq"])):
        for (path, w), (_, g) in zip(
                jax.tree_util.tree_flatten_with_path(want_tree)[0],
                jax.tree_util.tree_flatten_with_path(got_tree)[0]):
            w, g = np.asarray(w), np.asarray(g)
            scale = max(float(np.abs(w).max()), 1e-3)
            assert np.abs(g - w).max() <= 1e-6 * scale, path


def test_cosine_scheduler_matches_jax():
    kw = dict(warmup_steps=750, val_max=6e-4, val_min=6e-5, end_step=520000)
    got, want = CosineAnnealingScheduler(**kw), JaxCosine(**kw)
    for step in (0, 1, 375, 750, 751, 260375, 519999, 520000, 520001, 10 ** 7):
        assert got(step) == pytest.approx(float(want(step)), rel=1e-12,
                                          abs=1e-18), step
    assert got(750) == 6e-4 and got(520000) == pytest.approx(6e-5)


def test_corpus_lm_batches_match_jax(tmp_path):
    """The same corpus (lines over max_length resampled from RandomState(0),
    upper-case lines lowered) through both packages' CorpusLM, collate and
    loader: equal batches over two epochs."""
    rng = np.random.RandomState(0)
    words = ["w%d" % i for i in range(1, 12)]
    lines = [" ".join(words[j] for j in rng.randint(0, 11, rng.randint(1, 14)))
             for _ in range(40)]
    lines[3] = lines[3].upper()
    corpus = tmp_path / "corpus.txt"
    corpus.write_text("\n".join(lines) + "\n")
    tok = Tokenizer(["<unk>"] + [f"▁{w}" for w in words])
    tok_path = str(tmp_path / "tok.json")
    tok.save(tok_path)
    spec = dict(inputs_params=[{"axis": 0, "padding": True, "start_token": 12,
                                "padding_value": 0}],
                targets_params=[{"axis": 0, "padding": True,
                                 "end_token": 13, "padding_value": -1}])
    sets = []
    for corpus_cls, collate, loader in ((CorpusLM, CollateFn, DataLoader),
                                        (JaxCorpusLM, JaxCollateFn,
                                         JaxLoader)):
        ds = corpus_cls(batch_size=4, collate_fn=collate(
            **{k: [dict(p) for p in v] for k, v in spec.items()}),
            tokenizer_path=tok_path, max_length=8, corpus_path=str(corpus))
        sets.append(loader(ds, batch_size=4, drop_last=True))
    for epoch in range(2):
        for ld in sets:
            ld.set_epoch(epoch)
        got, want = (list(ld) for ld in sets)
        assert len(got) == len(want) == 10
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a["inputs"], b["inputs"])
            np.testing.assert_array_equal(a["targets"], b["targets"])
            assert (a["inputs"] != 0).sum(1).max() <= 9


def test_gpt_state_dict_round_trips_through_the_jax_converter():
    """A port GPT's state_dict through the JAX package's convert_state_dict
    gives back the JAX variables bit for bit, learned positions included."""
    _, params, model = _pair("learned")
    template = jckpt.state_dict_flatten({"params": params})
    flat, report = convert_state_dict(model.state_dict(), template)
    assert not report["unexpected"]
    assert set(flat) == set(template)
    for k, v in template.items():
        np.testing.assert_array_equal(flat[k], v)


NEURAL_CONFIG_JAX = """
import avec_tpu as nnet

vocab_size = 32
pad_token = 0
sos_token = vocab_size
eos_token = vocab_size
tokenizer_path = {tok_path!r}
callback_path = {callback_path!r}
precision = None

model = nnet.GPT(vocab_size=vocab_size + 1, padding_idx=pad_token,
                 max_pos_encoding=64, model="GPT-Tiny")
model.compile()
"""

NEURAL_CONFIG_PORT = """
from avec_tpu_torch.models.zoo import GPT

vocab_size = 32
pad_token = 0
sos_token = vocab_size
eos_token = vocab_size
tokenizer = {tok_path!r}
callback_path = {callback_path!r}


def build_model(device):
    return GPT(vocab_size=vocab_size + 1, padding_idx=pad_token,
               max_pos_encoding=64, model="GPT-Tiny", device=device)
"""


@pytest.fixture
def lm_setup(tmp_path):
    """A GPT-Tiny checkpoint (seeded JAX variables, the reference torch
    format) and an LM config for each package that loads it."""
    corpus = ["a b a", "b a b", "a a b", "b b a"]
    lm_tok = str(tmp_path / "lm_tok.json")
    Tokenizer(train_bpe(corpus, 16)).save(lm_tok)
    callback_path = str(tmp_path / "lm_callbacks")
    os.makedirs(callback_path)
    net = JaxGPTNet(vocab_size=33, padding_idx=0, max_pos_encoding=64,
                    model="GPT-Tiny")
    params, _ = init_variables(net, np.zeros((1, 8), np.int32),
                               training=False, seed=3)
    params = jax.tree.map(lambda a: a * 8.0, params)   # a peaked LM
    ckpt = "checkpoints_epoch_1_step_1.ckpt"
    save_checkpoint(os.path.join(callback_path, ckpt),
                    params_from_jax(params))
    configs = {}
    for name, text in (("jax", NEURAL_CONFIG_JAX), ("port", NEURAL_CONFIG_PORT)):
        configs[name] = str(tmp_path / f"lm_{name}.py")
        with open(configs[name], "w") as f:
            f.write(text.format(tok_path=lm_tok, callback_path=callback_path))
    return configs, ckpt


def _peaky(ids, v, t_per=2):
    lp = np.full((len(ids) * t_per, v), -10.0, np.float32)
    for i, c in enumerate(ids):
        lp[i * t_per:(i + 1) * t_per, c] = -0.01
    return lp


@pytest.mark.parametrize("alpha, beta", [(0.6, 1.0), (5.0, 0.0)])
def test_rescorer_matches_jax(tmp_path, lm_setup, alpha, beta):
    """The two cases of tests/test_neural_rescorer.py:72-120 with the same
    checkpoint in both packages: the decoders' rescorers built from their
    configs choose the same beams, with neural scores within 1e-4 (the
    second case's large alpha lets the GPT choose)."""
    configs, ckpt = lm_setup
    tok = Tokenizer(train_bpe(["a b a", "b a b", "a a b"], 8))
    tok_path = str(tmp_path / "ctc_tok.json")
    tok.save(tok_path)
    kw = dict(beam_size=4, neural_checkpoint=ckpt, neural_alpha=alpha,
              neural_beta=beta, use_native=False)
    want = JaxBeamDecoder(tok_path, neural_config_path=configs["jax"], **kw)
    got = CTCBeamSearchDecoder(tok_path, neural_config_path=configs["port"],
                               device="cpu", **kw)
    assert (got.neural_sos_token, got.neural_eos_token) == (32, 32)
    rng = np.random.RandomState(9)
    lp = np.stack([_peaky(tok.encode("a b"), tok.vocab_size()),
                   _peaky(tok.encode("b a"), tok.vocab_size())])
    lp = lp + rng.rand(*lp.shape).astype(np.float32) * 4.0
    lens = np.array([lp.shape[1]] * 2)
    assert got.beam_search(lp, lens) == want.beam_search(lp, lens)
    assert got((lp, lens)) == want((lp, lens))
    beams = got.search(lp - np.log(np.exp(lp).sum(-1, keepdims=True)), lens)
    for b in beams:
        while len(b) < 4:
            b.append(((), -np.inf))
    g_scores, g_lens = got.neural_scores(beams)
    w_scores, w_lens = want._neural_scores(beams)
    np.testing.assert_allclose(g_scores, w_scores, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(g_lens, w_lens)
    assert np.abs(w_scores).max() > 1.0


def test_gelu_ffn_stays_off_the_fused_kernel():
    """A GELU FFN with fused_ffn=True runs its unfused GELU layers in
    training (no launch, the GELU output); the AV model's K1 count per step
    stays 48 at the reference depth; LM-Tone's GPT counts none."""
    ffn = FeedForwardModule(16, 64, drop_rate=0.0, fused_ffn=True,
                            act_fun="GELU", inner_dropout=False)
    assert not ffn.fused_eligible()
    swish_ffn = FeedForwardModule(16, 64, drop_rate=0.0, fused_ffn=True)
    assert swish_ffn.fused_eligible()
    assert not FeedForwardModule(16, 64, drop_rate=0.1, fused_ffn=True,
                                 inner_dropout=False).fused_eligible()
    gen = torch.Generator().manual_seed(0)
    for p in ffn.parameters():
        p.data.normal_(0, 0.5, generator=gen)
    x = torch.randn(2, 5, 16, generator=gen)
    ffn.train()
    _cuda.reset_launches()
    norm, lin1, lin2 = (ffn.layers[k] for k in ("0", "1", "4"))
    want = lin2(torch.nn.functional.gelu(lin1(norm(x))))
    torch.testing.assert_close(ffn(x), want)
    assert sum(_cuda.launches.values()) == 0
    av = AudioVisualEfficientConformerInterCTC(device="cpu", fused_ffn=True)
    per_step = av.kernel_launches_per_step()
    assert per_step["fused_ffn_fwd"] == per_step["fused_ffn_bwd"] == 48
    gpt = lm_tone.build_model("cpu")
    assert gpt.kernel_launches_per_step() == {}
