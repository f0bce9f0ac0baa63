"""The port's continuous-batching server: slot recycling, per-slot
positions, EOS and max-token stopping, and agreement of the served tokens
with offline greedy decoding through the port's ``decode_step`` and through
the reference package's ``MD.decode_step`` on the same parameters.  (The
reference's own ``Server`` is not used: it needs its mesh layer.)"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import model as JMD

from repro_torch import configs as tconfigs
from repro_torch.launch import serve
from repro_torch.launch.serve import Request, Server
from repro_torch.models import model as TMD


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _greedy_port(cfg, params, prompt, max_new, eos_id=None):
    cache = TMD.init_cache(cfg, 1, 64, device="cpu")
    out = []
    for t in range(len(prompt) + max_new - 1):
        cur = prompt[t] if t < len(prompt) else out[-1]
        lg, cache = TMD.decode_step(cfg, params, cache, torch.tensor([cur]),
                                    torch.tensor([t]))
        if t >= len(prompt) - 1:
            out.append(int(lg[0].argmax()))
            if out[-1] == eos_id:
                break
    return out


def _greedy_reference(cfg, params, prompt, max_new):
    cache = JMD.init_cache(cfg, 1, 64)
    out = []
    for t in range(len(prompt) + max_new - 1):
        cur = prompt[t] if t < len(prompt) else out[-1]
        lg, cache = JMD.decode_step(cfg, params, cache,
                                    jnp.asarray([cur], jnp.int32),
                                    jnp.asarray([t], jnp.int32))
        if t >= len(prompt) - 1:
            out.append(int(jnp.argmax(lg[0])))
    return out


@pytest.mark.parametrize("arch", ["tinyllama_1_1b", "qwen3_0_6b"])
def test_server_matches_offline_and_reference_decode(arch):
    """3 requests on 2 slots (recycling), in f32 so that the two packages'
    greedy tokens agree exactly."""
    jcfg = dataclasses.replace(jconfigs.get_smoke(arch), compute_dtype="float32")
    cfg = dataclasses.replace(tconfigs.get_smoke(arch), compute_dtype="float32")
    jp = JMD.init_params(jcfg, jax.random.PRNGKey(0))
    params = TMD.params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    srv = Server(cfg, slots=2, max_len=64, device="cpu", params=params)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, size=5).tolist()
               for _ in range(3)]
    for rid, p in enumerate(prompts):
        srv.submit(Request(rid, p, max_new=4))
    done = {r.rid: r for r in srv.run()}
    assert len(done) == 3
    for rid, p in enumerate(prompts):
        want = _greedy_port(cfg, params, p, 4)
        assert done[rid].out == want, (rid, done[rid].out, want)
        assert want == _greedy_reference(jcfg, jp, p, 4), rid


def test_server_staggered_positions_eos_and_max_new():
    """A request admitted mid-flight decodes from position 0 while another
    slot is deep in its sequence; one request stops at EOS, the others at
    max_new (bf16, the model's dtype)."""
    cfg = tconfigs.get_smoke("qwen3_0_6b")
    params = TMD.init_params(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(2)
    long_p = rng.integers(0, cfg.vocab_size, size=12).tolist()
    short_p = rng.integers(0, cfg.vocab_size, size=3).tolist()
    eos_p = rng.integers(0, cfg.vocab_size, size=4).tolist()
    eos = _greedy_port(cfg, params, eos_p, 5)[2]     # its third new token
    srv = Server(cfg, slots=2, max_len=64, device="cpu", params=params,
                 eos_id=eos)
    srv.submit(Request(0, long_p, max_new=3))
    srv.submit(Request(1, short_p, max_new=3))
    srv.submit(Request(2, short_p, max_new=3))   # admitted when 1 finishes
    srv.submit(Request(3, eos_p, max_new=5))
    done = {r.rid: r for r in srv.run()}
    assert set(done) == {0, 1, 2, 3}
    want = _greedy_port(cfg, params, short_p, 3, eos)
    assert done[1].out == done[2].out == want
    assert done[0].out == _greedy_port(cfg, params, long_p, 3, eos)
    assert done[3].out == _greedy_port(cfg, params, eos_p, 5, eos)
    assert done[3].out[-1] == eos and len(done[3].out) <= 3
    for rid in (0, 1, 2):
        assert len(done[rid].out) == 3 or done[rid].out[-1] == eos


def test_serve_cli_on_cpu(capsys):
    serve.main(["--arch", "tinyllama-1.1b", "--device", "cpu",
                "--requests", "3", "--batch-slots", "2", "--max-new", "4"])
    out = capsys.readouterr().out
    assert "[serve]" in out and "3 requests" in out
    serve.main(["--arch", "olmoe-1b-7b", "--device", "cpu",
                "--requests", "3", "--batch-slots", "2", "--max-new", "4"])
    assert "3 requests" in capsys.readouterr().out
