"""The port's generator lint (repro_torch.analysis.keys), the counterpart of
tests/test_keys_lint.py.

The reference's key-discipline cases, recast for generators: a draw that
names its ``torch.Generator`` (or an explicit numpy ``Generator``) is
clean; a draw from a global stream -- torch's default generator, numpy's
module-level functions -- is flagged; ``# rng-ok: <reason>`` suppresses a
line; and the port's own tree lands at zero unsuppressed findings (the
gate the audit CLI enforces).
"""
import textwrap
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro_torch.analysis import keys  # noqa: E402


def lint(src: str):
    return keys.lint_source(textwrap.dedent(src))


def rules(findings):
    return [f.rule for f in keys.unsuppressed(findings)]


def test_draw_without_generator_flagged():
    out = lint("""
        import torch

        def f(shape):
            a = torch.randn(shape)
            b = torch.rand(shape, dtype=torch.float32)
            return a + b
    """)
    assert rules(out) == ["global-random", "global-random"]
    assert [f.line for f in out] == [5, 6]


def test_draw_with_generator_clean():
    out = lint("""
        import torch

        def f(gen, shape):
            a = torch.randn(shape, generator=gen)
            k = torch.randint(0, 5, shape, generator=gen)
            return a, k, torch.randperm(5, generator=gen)
    """)
    assert rules(out) == []


@pytest.mark.parametrize("fn", sorted(keys.TORCH_DRAWS))
def test_every_torch_draw_needs_its_generator(fn):
    flagged = lint(f"""
        import torch

        def f(x):
            return torch.{fn}(x)
    """)
    clean = lint(f"""
        import torch

        def f(x, gen):
            return torch.{fn}(x, generator=gen)
    """)
    assert rules(flagged) == ["global-random"] and rules(clean) == []


@pytest.mark.parametrize("fn", sorted(keys.TENSOR_DRAWS))
def test_in_place_draws_need_their_generator(fn):
    flagged = lint(f"""
        def f(t):
            return t.{fn}()
    """)
    clean = lint(f"""
        def f(t, gen):
            return t.{fn}(generator=gen)
    """)
    assert rules(flagged) == ["global-random"] and rules(clean) == []


def test_loop_and_comprehension_draws_flagged_once_a_site():
    out = lint("""
        import torch

        def f(n):
            out = [torch.rand(2) for _ in range(n)]
            for _ in range(n):
                out.append(torch.randn(2))
            return out
    """)
    assert rules(out) == ["global-random", "global-random"]


def test_alias_forms_resolve():
    out = lint("""
        import torch as th
        from torch import randn, rand as uniform
        import numpy.random as npr
        from numpy.random import normal

        def f():
            return th.randint(0, 3, (2,)), randn(2), uniform(2), npr.normal(), normal()
    """)
    assert rules(out) == ["global-random"] * 5


def test_host_global_stream_flagged_in_any_scope():
    out = lint("""
        import numpy as np

        def loss(params, batch):
            noise = np.random.normal(size=(2,))
            return (params * batch).sum() + noise.sum()

        def host_only(n):
            return np.random.permutation(n)
    """)
    assert rules(out) == ["global-random", "global-random"]


def test_explicit_numpy_streams_clean():
    out = lint("""
        import numpy as np

        def f(seed):
            rng = np.random.default_rng(seed)
            ss = np.random.SeedSequence(seed)
            gen = np.random.Generator(np.random.PCG64(ss))
            return rng.normal(size=3), gen.integers(5), rng.permutation(4)
    """)
    assert rules(out) == []


def test_suppression_comment():
    out = lint("""
        import torch

        def f():
            a = torch.rand(2)  # rng-ok: a timing operand, not a result
            return a
    """)
    assert [f.rule for f in out] == ["global-random"]
    assert out[0].suppressed
    assert keys.unsuppressed(out) == []


def test_parse_error_reported(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("def f(:\n")
    found = keys.lint_file(bad)
    assert [f.rule for f in found] == ["parse-error"]


def test_port_tree_has_zero_unsuppressed_findings():
    """The gate the audit CLI enforces, as a plain test: every draw in
    src/repro_torch names its generator (or is ``# rng-ok``'d)."""
    root = Path(__file__).resolve().parents[1] / "src" / "repro_torch"
    findings = keys.unsuppressed(keys.lint_paths([root]))
    assert findings == [], "\n".join(str(f) for f in findings)
