"""The port's serving path (`vmlmf_tpu_torch.serve.Decoder`) against the JAX
package's `Decoder`, with parameters transplanted from a JAX init: the whole
slice, prefill through the fused scan, then decode and beam search.

The two frameworks' random generators differ, so sampled tokens are checked
per framework (determinism, range), never across.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from vmlmf_tpu.cells import VMLMFCell as JaxVMLMFCell  # noqa: E402
from vmlmf_tpu.nn.models import LMModel as JaxLMModel  # noqa: E402
from vmlmf_tpu.serve import Decoder as JaxDecoder  # noqa: E402
from vmlmf_tpu_torch.cells import VMLMFCell  # noqa: E402
from vmlmf_tpu_torch.nn.models import LMModel  # noqa: E402
from vmlmf_tpu_torch.serve import Decoder  # noqa: E402
from vmlmf_tpu_torch.utils.transplant import params_from_jax  # noqa: E402

VOCAB, HIDDEN, LAYERS, B, T = 48, 32, 2, 3, 7
# winit 1.0 spreads the logits of a random model far enough apart that greedy
# decoding does not settle on one token and no greedy or beam choice hinges
# on the last bits of a sum


@pytest.fixture(scope="module")
def pair():
    kw = dict(vocab_size=VOCAB, hidden_size=HIDDEN, num_layers=LAYERS,
              dropout_rate=0.0, winit=1.0)
    jm = JaxLMModel(cell_factory=lambda n, h: JaxVMLMFCell(n, h, w_rank=6, u_rank=5),
                    backend="pallas", **kw)
    m = LMModel(cell_factory=lambda n, h: VMLMFCell(n, h, w_rank=6, u_rank=5),
                backend="fused", **kw)
    jparams = jm.init(jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    prompt = np.random.default_rng(1).integers(0, VOCAB, (T, B)).astype(np.int32)
    return (JaxDecoder(jm), jparams, jnp.asarray(prompt),
            Decoder(m), params, torch.from_numpy(prompt).long())


def test_prefill_matches_jax(pair):
    jdec, jparams, jprompt, dec, params, prompt = pair
    rng = np.random.default_rng(2)
    states = [tuple((0.2 * rng.standard_normal((B, HIDDEN))).astype(np.float32)
                    for _ in range(2)) for _ in range(LAYERS)]
    lj, sj = jdec.prefill(jparams, jprompt, [tuple(map(jnp.asarray, s)) for s in states])
    lt, st = dec.prefill(params, prompt, [tuple(map(torch.from_numpy, s)) for s in states])
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=2e-5, rtol=2e-5)
    for (h, c), (hj, cj) in zip(st, sj):
        np.testing.assert_allclose(h.numpy(), np.asarray(hj), atol=2e-5, rtol=2e-5)
        np.testing.assert_allclose(c.numpy(), np.asarray(cj), atol=2e-5, rtol=2e-5)


def test_greedy_generate_equals_jax(pair):
    jdec, jparams, jprompt, dec, params, prompt = pair
    want = np.asarray(jdec.generate(jparams, jprompt, max_new_tokens=8))
    got = dec.generate(params, prompt, max_new_tokens=8)
    assert got.shape == (8, B)
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(np.unique(want)) > 1  # the case is not a degenerate fixed point


def test_top_k_1_equals_greedy_and_chained_blocks_equal_one(pair):
    _, _, _, dec, params, prompt = pair
    greedy = dec.generate(params, prompt, max_new_tokens=6)
    k1 = dec.generate(params, prompt, max_new_tokens=6, temperature=0.8, top_k=1,
                      generator=torch.Generator().manual_seed(7))
    assert torch.equal(greedy, k1)
    logits, states = dec.prefill(params, prompt, dec.model.state0(B, "cpu"))
    a, states, logits = dec.decode(params, logits, states, steps=2, return_logits=True)
    b, _ = dec.decode(params, logits, states, steps=4)
    assert torch.equal(torch.cat([a, b]), greedy)


def test_sampling_deterministic_per_generator_and_in_vocab(pair):
    _, _, _, dec, params, prompt = pair

    def sample(seed):
        return dec.generate(params, prompt, max_new_tokens=8, temperature=1.0, top_k=20,
                            generator=torch.Generator().manual_seed(seed))

    a, b, c = sample(3), sample(3), sample(4)
    assert torch.equal(a, b)
    assert a.shape == (8, B) and int(a.min()) >= 0 and int(a.max()) < VOCAB
    assert not torch.equal(a, c)
    logits, states = dec.prefill(params, prompt, dec.model.state0(B, "cpu"))
    with pytest.raises(ValueError, match="Generator"):
        dec.decode(params, logits, states, steps=2, temperature=1.0)


@pytest.mark.parametrize("beams,penalty", [(4, 0.0), (3, 0.7)])
def test_beam_search_equals_jax(pair, beams, penalty):
    jdec, jparams, jprompt, dec, params, prompt = pair
    tj, sj = jdec.beam_search(jparams, jprompt, steps=5, beams=beams,
                              length_penalty=penalty)
    tt, st = dec.beam_search(params, prompt, steps=5, beams=beams, length_penalty=penalty)
    assert tt.shape == (5, B, beams) and st.shape == (B, beams)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(tj))
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=1e-5, rtol=0)


def test_beam_width_1_equals_greedy_and_too_wide_raises(pair):
    _, _, _, dec, params, prompt = pair
    toks, _ = dec.beam_search(params, prompt, steps=6, beams=1)
    assert torch.equal(toks[:, :, 0], dec.generate(params, prompt, max_new_tokens=6))
    with pytest.raises(ValueError, match="vocab_size"):
        dec.beam_search(params, prompt, steps=2, beams=VOCAB + 1)
