"""The plain reference against the port on the CPU at a tiny size: the same
weights and inputs, so the same function up to rounding, with and without
dropout, through one train step, the labels and the span decode."""

import json

import pytest
import torch

from benchmark import data
from benchmark.reference import seqpan as ref
from hual_tpu_torch.data.labels_device import make_span_labels_device
from hual_tpu_torch.models.seqpan import SeqPAN, seqpan_loss
from hual_tpu_torch.ops.decode import span_decode
from hual_tpu_torch.ops.optim import make_optimizer
from hual_tpu_torch.runtime import steps
from hual_tpu_torch.weights import load_jax_params

from conftest import ROOT, tiny_spec

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def world():
    spec = tiny_spec(json.loads((ROOT / "benchmark/configs/seqpan-charades.json").read_text()))
    inp = data.make_inputs(spec, 2**31 + 5, CPU)
    flat, weights = data.make_weights(spec, 2**31 + 5, CPU)
    m = spec["config"]["model"]
    port = SeqPAN(vdim=m["vdim"], dim=m["dim"], num_heads=m["num_heads"],
                  attn_layer=m["attn_layer"], max_vlen=m["max_vlen"], word_dim=m["word_dim"],
                  char_dim=m["char_dim"], num_chars=inp.dataset["n_chars"])
    load_jax_params(port, flat)
    net = data.reference_model(spec, CPU)
    net.load_state_dict(weights)
    split = inp.splits["train"]
    sel = torch.arange(16)
    return spec, inp, port, net, split.data(inp.table), sel


def _port_batch(cols, sel, labels=False):
    return steps.gather_batch(cols, sel, with_labels=labels)


def test_forward_agrees(world):
    _, inp, port, net, cols, sel = world
    a = port(_port_batch(cols, sel), inp.word_vectors)
    b = net(ref.gather(cols, sel), inp.word_vectors)
    for k in ("start_logits", "end_logits", "match_scores"):
        torch.testing.assert_close(a[k], b[k], rtol=1e-5, atol=1e-5)


def test_dropout_pass_draws_the_same_masks(world):
    _, inp, port, net, cols, sel = world
    a = port(_port_batch(cols, sel), inp.word_vectors, drop_rate=0.5,
             generator=steps.make_generator(CPU, 9, 1, 0))
    b = net(ref.gather(cols, sel), inp.word_vectors, rate=0.5, gen=ref.generator(CPU, 9, 1, 0))
    torch.testing.assert_close(a["start_logits"], b["start_logits"], rtol=1e-5, atol=1e-5)


def test_labels_and_decode_agree(world):
    _, inp, port, net, cols, sel = world
    batch = ref.gather(cols, sel)
    want = make_span_labels_device(batch["s_ind"], batch["e_ind"], batch["video_seq_len"], 8)
    got = ref.span_labels(batch["s_ind"], batch["e_ind"], batch["video_seq_len"], 8)
    for w, g in zip(want, got):
        assert torch.equal(w, g)
    out = net(batch, inp.word_vectors)
    for w, g in zip(span_decode(out["start_logits"], out["end_logits"], out["v_mask"]),
                    ref.span_decode(out["start_logits"], out["end_logits"], out["v_mask"])):
        assert torch.equal(w, g)


def test_one_train_step_agrees(world):
    spec, inp, port, net, cols, sel = world
    flat, weights = data.make_weights(spec, 2**31 + 5, CPU)
    load_jax_params(port, flat)
    net.load_state_dict(weights)
    pb = _port_batch(cols, sel, True)
    batch = ref.gather(cols, sel, with_labels=True)
    total, _ = seqpan_loss(port(pb, inp.word_vectors, pb["match_labels"]), pb)
    loss = ref.loss(net(batch, inp.word_vectors, batch["match_labels"]), batch)
    assert float(total.detach()) == pytest.approx(float(loss.detach()), rel=1e-5)   # no dropout
    opt = make_optimizer(port, 1.0, 0.01)
    m = steps.train_step(port, opt, pb, inp.word_vectors, 1e-4,
                         steps.make_generator(CPU, 22, 0), drop_rate=0.2)
    leaves = {k: p for k, p, _, _ in ref.jax_leaves(net)}
    keys = list(leaves)
    ropt = ref.BertAdamW([leaves[k] for k in keys], [ref.decayed(k) for k in keys])
    out = net(batch, inp.word_vectors, batch["match_labels"], rate=0.2,
              gen=ref.generator(CPU, 22, 0))
    loss = ref.loss(out, batch)
    ropt.step(torch.autograd.grad(loss, [leaves[k] for k in keys], materialize_grads=True), 1e-4)
    assert float(m["loss"]) == pytest.approx(float(loss.detach()), rel=1e-5)
    got = dict(zip(opt.keys, opt.mu))
    for k, mu in zip(keys, ropt.mu):
        torch.testing.assert_close(got[k].reshape(-1).norm(), mu.norm(), rtol=1e-4, atol=1e-9)
    for k, p in zip(opt.keys, opt.params):
        torch.testing.assert_close(p.detach(), leaves[k].detach(), rtol=1e-5, atol=1e-7)
