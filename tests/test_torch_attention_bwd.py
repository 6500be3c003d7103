"""The attention backward's tensor-core kernel, checked on the CPU.

``csrc/flash_attention_bwd.cu`` runs bfloat16 on Hopper's tensor cores:
bf16 operands, products summed in float32, and the two float32 operands
that the products take from registers, P and dS, each issued as a bf16 high
part plus the bf16 rest. The card tests (``tests/test_torch_cuda.py``) hold
the kernel itself against ``flash_attention_bwd_ref``; here the kernel's
roundings are replayed in PyTorch on the card tests' shapes, so that the
split's margin against the gate (1e-5 of each gradient's largest entry
beyond the outputs' bf16 rounding) is known without a card, and so is the
loss of one bf16 for P and dS. Not replayed: ``ex2.approx`` (about two
float32 ulps) and the order of the float32 sums inside a product.

Also: the kernel build's cache tag covers the headers a source includes.
"""
import shutil

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from test_torch_cuda import BWD_CASES  # noqa: E402

LOG2E = 1.4426950408889634
GATE = 1e-5                 # of each gradient's largest entry
HALF_ULP = 2.0 ** -8        # the outputs' own rounding to bf16, relative


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _split(x, both):
    """x as the kernel issues it: [bf16(x), bf16(x - bf16(x))], or only the
    first part."""
    hi = _bf16(x)
    return [hi, _bf16(x - hi)] if both else [hi]


def tensor_core_bwd(q, k, v, o, do, m, l, *, causal, window, q_offset, split=True):
    """The bf16 kernel's arithmetic in PyTorch, on float32 tensors that hold
    bf16 values: lse = m log2(e) + log2(max(l, 1e-30)) rounded once (an
    FMA), P = 2^(S scale log2(e) - lse) (the exponent one FMA) or 0 where
    masked, D = rowsum(do o), dS = P (dP - D); every product in float32
    with P and dS as their split parts; dq, dk, dv rounded to bf16."""
    B, T, H, Dh = q.shape
    S, Kv = k.shape[1], k.shape[2]
    scale = Dh ** -0.5
    w_eff = window if window > 0 else S + T
    kh, vh = fa._expand_kv(k, H), fa._expand_kv(v, H)
    s = torch.einsum("bthd,bshd->bhts", q, kh)
    lse = (m.double() * LOG2E + torch.log2(torch.clamp_min(l, 1e-30)).double()).float()
    x = (s.double() * (scale * LOG2E) - lse[..., None].double()).float()
    qpos = torch.arange(T)[:, None] + q_offset
    kpos = torch.arange(S)[None, :]
    live = (kpos > qpos - w_eff) & ((kpos <= qpos) if causal else True)
    p = torch.where(live, torch.exp2(x), torch.zeros(()))
    dvec = torch.sum(do * o, dim=-1).transpose(1, 2)                  # [B, H, T]
    ds = p * (torch.einsum("bthd,bshd->bhts", do, vh) - dvec[..., None])
    dq = sum(torch.einsum("bhts,bshd->bthd", part, kh) for part in _split(ds, split)) * scale
    dk = sum(torch.einsum("bhts,bthd->bshd", part, q) for part in _split(ds, split)) * scale
    dv = sum(torch.einsum("bhts,bthd->bshd", part, do) for part in _split(p, split))
    group = lambda a: a.reshape(B, S, Kv, H // Kv, Dh).sum(dim=3)  # noqa: E731
    return _bf16(dq), _bf16(group(dk)), _bf16(group(dv))


def _gate_share(got, want):
    """Largest excess of |got - want| beyond half a bf16 ulp of want, as a
    share of want's largest entry (the card tests' and phase 15's gate)."""
    excess = (got - want).abs() - HALF_ULP * want.abs()
    return excess.max().item() / want.abs().max().item()


@pytest.mark.parametrize("B,T,S,H,Kv,Dh,causal,win,off", BWD_CASES)
def test_tensor_core_split_meets_the_gate(record_property, B, T, S, H, Kv, Dh, causal, win,
                                          off):
    """The hi/lo split of P and dS keeps the bf16 kernel's arithmetic within
    the gate of the float32 plain version on every card shape; one bf16 for
    P and dS would not."""
    rng = np.random.default_rng(T + S + off)
    q, k, v, do = (_bf16(torch.from_numpy(rng.standard_normal(shape).astype(np.float32)))
                   for shape in ((B, T, H, Dh), (B, S, Kv, Dh), (B, S, Kv, Dh), (B, T, H, Dh)))
    kw = dict(causal=causal, window=win, q_offset=off)
    o, m, l = fa.flash_attention_ref(q, k, v, block=64, return_stats=True, **kw)
    o = _bf16(o)                    # the bf16 forward's output
    want = fa.flash_attention_bwd_ref(q, k, v, o, do, m, l, block=64, **kw)
    shares = {}
    for split in (True, False):
        got = tensor_core_bwd(q, k, v, o, do, m, l, split=split, **kw)
        shares[split] = max(_gate_share(g, w) for g, w in zip(got, want))
    record_property("split_share_of_gate", shares[True] / GATE)
    record_property("one_bf16_share_of_gate", shares[False] / GATE)
    assert shares[True] <= GATE
    assert shares[False] > GATE


def test_library_tag_follows_included_headers(tmp_path, monkeypatch):
    """A library's cache tag hashes its source and every ``csrc`` header it
    includes, so an edited header rebuilds what includes it, and only
    that."""
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    assert [p.name for p in build.source_files("flash_attention_bwd")] == [
        "flash_attention_bwd.cu", "hopper.cuh"]
    before = {name: build.library_path(name) for name in build.SOURCES}
    header = csrc / "hopper.cuh"
    header.write_bytes(header.read_bytes() + b"\n// edited\n")
    after = {name: build.library_path(name) for name in build.SOURCES}
    changed = {name for name in build.SOURCES if after[name] != before[name]}
    assert changed == {"flash_attention", "flash_attention_bwd"}
