"""Greedy serving in the port (``repro_torch.launch.serve``) against the
JAX package's greedy loop (``src/repro/launch/serve.py:66-81``) on the CPU:
from the same reduced float32 params and prompts, both generate the same
tokens (argmax over all ``vocab_padded`` columns). gemma3-27b runs at 7
layers (one global), and the windowed archs' prompts of 19 tokens exceed
their reduced window of 16."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.models.transformer import build_model as jbuild  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.transformer import build_model  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """One intra-op thread: the suite runs files in parallel workers, and
    PyTorch's default of one thread per core would crowd out the other
    workers' (timing-sensitive) tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_greedy(bundle, params, toks, gen):
    B, T = toks.shape
    cache = bundle.init_cache(B, T + gen)
    logits, cache = jax.jit(bundle.prefill)(params, {"tokens": toks}, cache)
    decode = jax.jit(bundle.decode_step)
    tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    out = [tok]
    for i in range(gen - 1):
        logits, cache = decode(params, {"token": tok, "index": jnp.asarray(T + i, jnp.int32)},
                               cache)
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        out.append(tok)
    return np.asarray(jnp.concatenate(out, 1))


@pytest.mark.parametrize("arch", ["qwen3-14b", "rwkv6-1.6b", "qwen2.5-32b", "gemma3-27b",
                                  "hymba-1.5b", "granite-moe-1b-a400m"])
def test_greedy_tokens_match_reference(arch):
    over = dict(num_layers=7) if arch == "gemma3-27b" else {}
    jb = jbuild(jget_arch(arch).reduced(**over))
    jp = jb.init(jax.random.PRNGKey(0))
    toks = np.random.default_rng(0).integers(0, 256, (3, 19)).astype(np.int32)
    want = _jax_greedy(jb, jp, jnp.asarray(toks), 10)
    tb = build_model(get_arch(arch).reduced(**over))
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    got = serve.generate(tb, tp, torch.from_numpy(toks), 10)
    assert got.tokens.dtype == torch.int32 and tuple(got.tokens.shape) == (3, 10)
    np.testing.assert_array_equal(got.tokens.numpy(), want)
    assert got.prefill_ms > 0 and got.decode_ms > 0


def test_serve_steps_and_cli(capsys):
    tb = build_model(get_arch("rwkv6-1.6b").reduced())
    assert serve.make_serve_step(tb, "prefill") is tb.prefill
    assert serve.make_serve_step(tb, "decode") is tb.decode_step
    with pytest.raises(ValueError):
        serve.make_serve_step(tb, "train")
    with pytest.raises(ValueError, match="gen"):
        serve.generate(tb, tb.init(0, device="cpu"), torch.zeros(1, 3, dtype=torch.int32), 0)
    serve.main(["--arch", "qwen3-14b", "--smoke", "--device", "cpu", "--batch", "2",
                "--prompt-len", "9", "--gen", "3"])
    out = capsys.readouterr().out
    assert "arch=qwen3-14b device=cpu generated (2, 3)" in out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            serve.main(["--arch", "rwkv6-1.6b", "--smoke"])


@pytest.mark.parametrize("arch", ["qwen2.5-32b", "gemma3-27b", "hymba-1.5b"])
def test_cli_serves_the_windowed_and_hybrid_archs(arch, capsys):
    serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2",
                "--prompt-len", "20", "--gen", "3"])
    assert f"arch={arch} device=cpu generated (2, 3)" in capsys.readouterr().out
