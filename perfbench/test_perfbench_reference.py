"""The plain references against the program's own model at its reduced
sizes, the weights' layout against the program's init, and the decode
step's counts against the published parameter counts."""
import json

import pytest
import torch

from perfbench import harness
from perfbench.reference import decoder, mamba2

CELLS = {"stablelm-1.6b": decoder, "mamba2-2.7b": mamba2}


def _config(name):
    return json.loads((harness.BENCH / "configs" / f"{name}.json").read_text())


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


@pytest.mark.parametrize("name", sorted(CELLS))
def test_reference_is_the_programs_model(name):
    """float32 at the program's reduced sizes: the reference's logits at
    every position are the program's forward's (unquantized, no cache)."""
    from repro_torch.models.transformer import lm_apply, lm_logits
    config = _config(name)
    cfg = harness.port_config(config, small=True)
    model = harness.model_sizes(cfg, config["model"])
    w = CELLS[name].make_weights(model, 3, "cpu")
    torch.manual_seed(0)
    tokens = torch.randint(0, model["vocab"], (40,))
    h, _, _ = lm_apply(w, cfg, tokens=tokens[None], positions=torch.arange(40)[None],
                       mode="train")
    want = lm_logits(w, cfg, h[0])
    got = CELLS[name].forward(w, model, tokens)
    assert got.shape == want.shape
    assert (got - want).abs().max().item() < 1e-4 * want.abs().max().item()
    # the control moves the logits well past that
    assert (CELLS[name].forward(w, model, tokens, bits=4) - want).abs().max() > 1e-2


@pytest.mark.parametrize("name", sorted(CELLS))
def test_weights_have_the_programs_layout(name):
    from repro_torch.models import build_model
    config = _config(name)
    cfg = harness.port_config(config, small=True)
    mine = dict(_leaves(CELLS[name].make_weights(harness.model_sizes(cfg, config["model"]),
                                                 5, "cpu")))
    theirs = dict(_leaves(build_model(cfg, "cpu").init(5)))
    assert mine.keys() == theirs.keys()
    for k in mine:
        assert (mine[k].shape, mine[k].dtype) == (theirs[k].shape, theirs[k].dtype), k


@pytest.mark.parametrize("name,params", [("stablelm-1.6b", 1_233_125_376),
                                         ("mamba2-2.7b", 2_571_632_640)])
def test_counts_at_published_sizes(name, params):
    """The int8 projections' parameters: the configuration's count, the
    program's own init (shapes only) and the published count agree."""
    from repro_torch.models.layers import MetaGenerator
    from repro_torch.models.transformer import lm_init
    config = _config(name)
    m, ref = config["model"], CELLS[name]
    assert ref.proj_params(m) == params
    meta = lm_init(MetaGenerator(), harness.port_config(config, small=False))
    proj = sum(t.numel() for path, t in _leaves(meta)
               if path[-1] in decoder.PROJ or str(path[-1]).endswith("_proj"))
    assert proj == params
    emb = m["vocab"] * m["d_model"] * 2
    one_row = ref.decode_bytes(m, 1, 640) - ref.decode_bytes(m, 0, 0)
    if name == "stablelm-1.6b":
        assert decoder.kv_token_bytes(m) == 24 * 32 * (2 * 64 + 8)          # ~104 KB
        assert one_row == 641 * decoder.kv_token_bytes(m) + 24 * 4
    else:
        state = 64 * (80 * 64 * 128 * 4 + 3 * 5376 * 2)                     # ~170 MB a row
        assert one_row == 2 * state
        assert ref.decode_bytes(m, 64, 0) - ref.decode_bytes(m, 64, 10 ** 6) == 0
    assert ref.decode_bytes(m, 0, 0) > params + emb
    int8, flops = ref.decode_ops(m, 64, 64 * 640)
    assert int8 == 2 * params * 64 and flops > 2 * m["vocab"] * m["d_model"] * 64


def test_chunked_ssd_is_the_recurrence(monkeypatch):
    """The reference's SSD by chunks equals the step-by-step recurrence
    across chunk boundaries."""
    g = torch.Generator().manual_seed(1)
    S, H, P, N = 40, 3, 4, 5
    x, B, C = (torch.randn(s, generator=g) for s in ((S, H, P), (S, N), (S, N)))
    dt = torch.rand((S, H), generator=g)
    A = -torch.linspace(1.0, 4.0, H)
    h, want = torch.zeros((H, P, N)), []
    for t in range(S):
        h = h * torch.exp(dt[t] * A)[:, None, None] + (dt[t][:, None] * x[t])[..., None] * B[t]
        want.append(h @ C[t])
    monkeypatch.setattr(mamba2, "CHUNK", 8)
    assert torch.allclose(mamba2._ssd(x, dt, A, B, C), torch.stack(want), atol=1e-5)
