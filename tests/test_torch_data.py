"""The port's synthetic LM pipeline (``repro_torch.data``) against the
reference's (``repro.data``).

A batch is a pure function of (seed, step) drawn from a SplitMix64-seeded
``torch.Generator``, so its numbers differ from the reference's threefry
draws (ROADMAP queue 3); the transforms are the reference's. Pinned here:
determinism per (seed, step) and independence of the order of calls (the
card's batches equal the CPU's: ``tests/test_torch_cuda.py``); shapes and
dtypes equal to ``make_batch_specs`` and to the
reference's specs; labels the tokens shifted by one; the bigram kick and
the Zipf-ish id statistics close to the reference's over 100 batches.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

from repro import configs as RC
from repro.configs.base import TRAIN_4K as REF_TRAIN_4K
from repro.data import SyntheticLM as RefSyntheticLM
from repro.data import make_batch_specs as ref_batch_specs
from repro_torch import configs as TC
from repro_torch.configs.base import TRAIN_4K
from repro_torch.data import SyntheticLM, make_batch_specs

ARCHS = ["qwen3_4b", "pixtral_12b", "whisper_medium"]   # text, vision, audio


def pipe(arch, seed=0, b=4, s=64):
    cfg = TC.get(arch).reduced()
    return SyntheticLM(cfg, dataclasses.replace(TRAIN_4K, seq_len=s,
                                                global_batch=b),
                       seed=seed, device="cpu")


def ref_pipe(arch, seed=0, b=4, s=64):
    cfg = RC.get(arch).reduced()
    return RefSyntheticLM(cfg, dataclasses.replace(REF_TRAIN_4K, seq_len=s,
                                                   global_batch=b), seed=seed)


@pytest.mark.parametrize("arch", ARCHS)
def test_batch_is_a_pure_function_of_seed_and_step(arch):
    a, b = pipe(arch), pipe(arch)
    later = a.batch(7)
    a.batch(3)
    for k, v in b.batch(7).items():
        assert torch.equal(v, later[k]), k
    assert not torch.equal(a.batch(8)["tokens"], later["tokens"])
    assert not torch.equal(pipe(arch, seed=1).batch(7)["tokens"],
                           later["tokens"])


@pytest.mark.parametrize("arch", ARCHS)
def test_shapes_and_dtypes_equal_the_specs(arch):
    p = pipe(arch)
    batch = p.batch(0)
    specs = make_batch_specs(p.cfg, p.shape)
    ref_specs = ref_batch_specs(RC.get(arch).reduced(),
                                dataclasses.replace(REF_TRAIN_4K, seq_len=64,
                                                    global_batch=4))
    assert batch.keys() == specs.keys() == ref_specs.keys()
    for k, v in batch.items():
        assert v.shape == specs[k].shape and v.dtype == specs[k].dtype, k
        assert specs[k].is_meta and v.device.type == "cpu"
        assert tuple(v.shape) == ref_specs[k].shape, k
        assert str(v.dtype) == f"torch.{ref_specs[k].dtype}", k
    ref = ref_pipe(arch).batch(0)
    assert {k: tuple(v.shape) for k, v in batch.items()} == \
        {k: v.shape for k, v in ref.items()}
    if "frontend_embeds" in batch:
        fe = batch["frontend_embeds"].float()
        assert 0.015 < float(fe.std()) < 0.025       # 0.02 * N(0, 1)


def test_labels_are_the_tokens_shifted_by_one():
    """Drawn over S + 1 positions: labels[:, t] is tokens[:, t + 1]."""
    p = pipe("qwen3_4b")
    batch = p.batch(2)
    assert torch.equal(batch["labels"][:, :-1], batch["tokens"][:, 1:])


def _stats(tokens, labels, vocab):
    """Fraction of positions where the label follows the bigram rule from
    the token, of id 0, and the ids' mean and median over the vocab."""
    rule = ((tokens.astype(np.int64) * 7 + 13) % vocab == labels).mean()
    return np.array([rule, (tokens == 0).mean(), tokens.mean() / vocab,
                     np.median(tokens) / vocab])


def test_statistics_match_the_reference():
    """The kick replaces half the tokens by (previous * 7 + 13) % vocab,
    computed from the token before any kick; the rule shows between a
    token and its label where the label was kicked and the token was not
    (a quarter of positions, plus chance matches): 0.25 in both packages.
    The ids are floor(vocab * u^3): id 0 takes vocab^(-1/3) of the
    unkicked mass, and id 13 as much of the kicked."""
    vocab = TC.get("qwen3_4b").reduced().vocab
    p, r = pipe("qwen3_4b"), ref_pipe("qwen3_4b")
    mine = np.concatenate([np.stack([p.batch(i)[k].numpy()
                                     for k in ("tokens", "labels")])
                           for i in range(100)], axis=1)
    theirs = np.concatenate([np.stack([np.asarray(r.batch(i)[k])
                                       for k in ("tokens", "labels")])
                             for i in range(100)], axis=1)
    a, b = _stats(*mine, vocab), _stats(*theirs, vocab)
    assert 0.22 < a[0] < 0.30 and 0.22 < b[0] < 0.30
    np.testing.assert_allclose(a, b, atol=0.02)
    # the two most common ids: 0, and 13, its kicked successor
    counts = np.bincount(mine[0].ravel(), minlength=vocab)
    assert set(np.argsort(counts)[-2:]) == {0, 13}


def test_cuda_is_the_default_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TC.get("qwen3_4b").reduced()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SyntheticLM(cfg, TRAIN_4K)
