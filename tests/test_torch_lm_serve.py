"""The port's serving launcher against the reference's serving loop.

``repro_torch.launch.serve.generate`` on reduced configs of a dense, an
SSM, a hybrid and an MLA family gives the same greedy tokens as a JAX loop
that mirrors ``src/repro/launch/serve.py:48-66`` (prefill token by token
through ``decode_step`` into a serve-length cache, then greedy decode) on
the same carried weights and prompt; the logits the first token is drawn
from agree within 1e-4. The command line runs on the CPU when asked and
exits non-zero without a GPU otherwise.
"""

import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

from repro import configs as RC
from repro.models import build_model as ref_build
from repro_torch import configs as TC
from repro_torch.launch.serve import generate
from repro_torch.models import build_model, params_from_reference

REPO = pathlib.Path(__file__).resolve().parent.parent


def reference_serve_loop(rmodel, params, prompt, gen):
    """``repro/launch/serve.py:48-66``: (tokens (B, gen), last prompt
    logits)."""
    decode = jax.jit(rmodel.decode_step)
    b, s = prompt.shape
    cache = rmodel.init_cache(b, s + gen)
    pos = 0
    for t in range(s):
        logits, cache = decode(params, cache, prompt[:, t:t + 1],
                               jnp.int32(pos))
        pos += 1
    first = logits
    nxt = jnp.argmax(logits, axis=-1)[:, None].astype(jnp.int32)
    out = [nxt]
    for _ in range(gen - 1):
        logits, cache = decode(params, cache, nxt, jnp.int32(pos))
        nxt = jnp.argmax(logits, axis=-1)[:, None].astype(jnp.int32)
        out.append(nxt)
        pos += 1
    return np.asarray(jnp.concatenate(out, axis=1)), np.asarray(first)


@pytest.mark.parametrize("arch", ["qwen3_4b", "mamba2_130m", "hymba_1_5b",
                                  "deepseek_v3_671b"])
def test_generate_matches_the_reference_loop(arch):
    rcfg, cfg = RC.get(arch).reduced(), TC.get(arch).reduced()
    rmodel = ref_build(rcfg)
    params = rmodel.init_params(jax.random.key(0))
    model = build_model(cfg, device="cpu")
    model.load_state_dict(params_from_reference(
        cfg, jax.tree.map(np.asarray, params)))
    prompt = np.random.default_rng(1).integers(
        0, cfg.vocab, (4, 16)).astype(np.int32)
    ref_tokens, ref_first = reference_serve_loop(rmodel, params,
                                                 jnp.asarray(prompt), 8)
    tokens, timings = generate(model, torch.from_numpy(prompt), 8)
    np.testing.assert_allclose(timings["logits"].numpy(), ref_first,
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(tokens.numpy(), ref_tokens)
    assert timings["prompt_len"] == 16
    assert len(timings["step_ms"]) == 16 + 7 and timings["wall_s"] > 0


def run_cli(*args, env_extra=None):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), **(env_extra or {}))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "qwen3_4b", "--reduced", "--batch", "2", "--prompt-len", "4",
         "--gen", "3", *args], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=300)


def test_cli_runs_on_the_cpu_when_asked():
    out = run_cli("--device", "cpu")
    assert out.returncode == 0, out.stderr
    assert "qwen3-4b-reduced: generated (2, 3)" in out.stdout
    assert out.stdout.splitlines()[-1].startswith("sample: [")


def test_cli_refuses_without_a_gpu():
    out = run_cli(env_extra={"CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert "device='cpu'" in out.stderr
    assert "generated" not in out.stdout
