"""Autoregressive serving for the LM: prefill, stateful decode, sampling and
beam search (counterpart of `vmlmf_tpu.serve.decoder`).

  * prefill — the prompt ``[T, B]`` runs through the model's scan backend
    (on "fused", one kernel call per layer; on "fused_pipelined", one call
    of the no-grad stack kernel per group of layers) and returns the carried
    ``(h, c)`` per layer and the last position's logits, copies.
  * decode — one token step after another: pick the next token, embed it,
    run each layer's ``cell.step`` on factors whose weight-only ``prepare``
    is done once per call, not per token, and project to logits with a head
    weight made once per call (under ``head_bf16``, its bf16 copy).
  * sampling — greedy (``temperature=None``), temperature, and ``top_k``;
    randomness from an explicit `torch.Generator` on the logits' device.
    The temperature is a 0-d tensor on the device, a runtime value.
  * beam search — one step scores the beams' continuations, keeps the best,
    gathers the surviving parents' states and records (token, parent).

On CUDA, decode and beam search replay one captured CUDA graph of their
step per token (`utils.graphs.StepGraph`), the counterpart of the JAX
package's one-scan ``_decode_jit`` and ``_beam_jit``: the logits, the
token, the scores and the per-layer ``(h, c)`` are static tensors that the
step updates in place. A sampling graph draws from a generator of its own,
set from the caller's before the tokens and copied back after them, so the
caller's generator is a value of each call, as the JAX package's key is.
Prefill is one replay of a captured prefill, the counterpart of the JAX
package's jitted ``prefill``; `generate` and `beam_search` start with it.
The graphs stay on the `Decoder`, keyed by the mode, the batch, the top-k,
the dtype and the parameters' storage (a prefill's by the prompt's shape
and dtype, the states' and the backend): a second call like the first
captures nothing; new parameter tensors capture again. Token steps and
prefills are cached apart, each cache holding at most `CACHED_GRAPHS`, so a
call's prefill never evicts its decode graph. On the CPU the same steps
run eagerly.

Everything runs under `torch.inference_mode`.
"""

from __future__ import annotations

import dataclasses

import torch

from vmlmf_tpu_torch.utils.graphs import StepGraph, copy_tree, drawing_from, graph_key, on_card
from vmlmf_tpu_torch.utils.tree import tree_leaves

CACHED_GRAPHS = 8  # captured steps a Decoder keeps of each kind; the oldest goes first


def _top_k_mask(logits, k):
    """Keep the k largest logits per row, set the rest to the dtype's min."""
    thresh = torch.topk(logits, k, dim=-1).values[..., -1:]
    neg = torch.finfo(logits.dtype).min
    return torch.where(logits < thresh, torch.full_like(logits, neg), logits)


def _clone_states(states):
    return [tuple(s.clone() for s in st) for st in states]


@dataclasses.dataclass
class _Step:
    """A token step over static tensors: ``run()`` is one step (captured
    and replayed on CUDA, eager on the CPU); ``tensors`` are what it reads
    and updates, by name (its ``generator`` too, on CUDA the graph's own)."""

    run: object
    tensors: dict


@dataclasses.dataclass(frozen=True)
class Decoder:
    """Serving wrapper over an `LMModel`."""

    model: object  # LMModel
    # captured token steps (decode, beam search) and captured prefills
    _graphs: dict = dataclasses.field(default_factory=dict, init=False, repr=False,
                                      compare=False)
    _prefills: dict = dataclasses.field(default_factory=dict, init=False, repr=False,
                                        compare=False)

    def _preps(self, params):
        return tuple(cell.prepare(p) for cell, p in zip(self.model.rnn.cells, params["rnn"]))

    def _token_step(self, params, preps, head, tok, states):
        """One decode position: tok [B] -> (logits [B, V], new states)."""
        x = self.model.embed(params["embed"], tok)
        new_states = []
        for cell, prep, s in zip(self.model.rnn.cells, preps, states):
            s, x = cell.step(prep, cell.inp(prep, x), s)
            new_states.append(s)
        return self.model._logits(params, x, head), new_states

    def _step(self, cache, key, params, tensors, body, dev):
        """The `_Step` of ``body(**tensors)`` on ``dev`` for ``key``: on CUDA
        the graph cached in ``cache`` (built and captured on first use, with
        a generator of its own where ``tensors`` has one), its tensors
        refreshed from ``tensors``; on the CPU, ``body`` on ``tensors``."""
        if not on_card(dev):
            return _Step(lambda: body(**tensors), tensors)
        key = (key, graph_key(tree_leaves(params)))
        step = cache.get(key)
        if step is None:
            if len(cache) >= CACHED_GRAPHS:
                cache.pop(next(iter(cache)))
            static = dict(tensors)  # this call's own tensors become the graph's
            if static.get("generator") is not None:
                static["generator"] = torch.Generator(dev)
            graph = StepGraph(lambda: body(**static), device=dev,
                              generators=(static.get("generator"),))
            step = cache[key] = _Step(graph, static)
        else:
            copy_tree([step.tensors[k] for k in tensors], list(tensors.values()))
        return step

    def _tensors(self, params, states, **extra):
        """The tensors a token step reads and updates, this call's own
        (``states``, ``extra`` and the preps are fresh; the head reads the
        parameters' storage or is a fresh bf16 copy)."""
        return dict(extra, states=[tuple(s) for s in states], preps=self._preps(params),
                    head=self.model.head_weight(params))

    @torch.inference_mode()
    def prefill(self, params, ids, states):
        """Consume the prompt. ids [T, B] -> (last logits [B, V], states),
        copies (on CUDA, out of the graph's pool, which the next replay
        overwrites)."""

        def body(ids, states):
            x, new_states = self.model.apply_hidden(params, ids, states, train=False)
            return self.model._logits(params, x[-1]), new_states

        key = ("prefill", tuple(ids.shape), ids.dtype, self.model.backend,
               tuple((tuple(s.shape), s.dtype) for s in tree_leaves(states)))
        tensors = dict(ids=ids.clone(), states=_clone_states(states))
        logits, states = self._step(self._prefills, key, params, tensors, body,
                                    ids.device).run()
        return logits.clone(), _clone_states(states)

    @torch.inference_mode()
    def decode(self, params, last_logits, states, *, steps, generator=None,
               temperature=None, top_k=None, return_logits=False):
        """Generate `steps` tokens. -> (tokens [steps, B], states), or
        (tokens, states, last_logits) with ``return_logits=True`` to chain
        decode blocks.

        temperature=None -> greedy argmax; otherwise categorical sampling at
        that temperature from ``generator``, optionally restricted to the
        `top_k` largest logits.
        """
        greedy = temperature is None
        if not greedy and generator is None:
            raise ValueError("sampling (temperature != None) requires a torch.Generator")
        b, dev = last_logits.shape[0], last_logits.device
        temp = torch.full((), 1.0 if greedy else temperature, dtype=torch.float32, device=dev)

        def body(logits, states, preps, head, temp, generator):
            if greedy:
                tok = torch.argmax(logits, dim=-1)
            else:
                lg = _top_k_mask(logits, top_k) if top_k is not None else logits
                probs = torch.softmax(lg / temp, dim=-1)
                tok = torch.multinomial(probs, 1, generator=generator).squeeze(-1)
            new_logits, new_states = self._token_step(params, preps, head, tok, states)
            logits.copy_(new_logits)
            copy_tree(states, new_states)
            return (tok,)

        key = ("decode", b, greedy, top_k, last_logits.dtype)
        tensors = self._tensors(params, _clone_states(states), logits=last_logits.clone(),
                                temp=temp, generator=None if greedy else generator)
        step = self._step(self._graphs, key, params, tensors, body, dev)
        tokens = torch.empty((steps, b), dtype=torch.long, device=dev)
        with drawing_from(step.tensors["generator"], tensors["generator"]):
            for i in range(steps):
                tokens[i] = step.run()[0]
        states = _clone_states(step.tensors["states"])
        if return_logits:
            return tokens, states, step.tensors["logits"].clone()
        return tokens, states

    def generate(self, params, prompt_ids, *, max_new_tokens, generator=None,
                 temperature=None, top_k=None):
        """prompt_ids [T, B] -> generated tokens [max_new_tokens, B]."""
        states = self.model.state0(prompt_ids.shape[1], prompt_ids.device)
        last_logits, states = self.prefill(params, prompt_ids, states)
        tokens, _ = self.decode(params, last_logits, states, steps=max_new_tokens,
                                generator=generator, temperature=temperature, top_k=top_k)
        return tokens

    @torch.inference_mode()
    def beam_search(self, params, prompt_ids, *, steps, beams, length_penalty=0.0):
        """Fixed-length beam search. prompt_ids [T, B] ->
        (tokens [steps, B, W], scores [B, W]), beams sorted by descending total
        log-probability (divided by steps**length_penalty when it is > 0).

        Each step scores [B, W*V] continuations, keeps the top W per batch row,
        gathers the recurrent states of the surviving parents and records
        (token, parent); the sequences are then read back along the parents.
        """
        if beams > self.model.vocab_size:
            raise ValueError(
                f"beams={beams} exceeds vocab_size={self.model.vocab_size}; "
                f"top_k cannot select more continuations than the vocabulary")
        b, w = prompt_ids.shape[1], beams
        states = self.model.state0(b, prompt_ids.device)
        last_logits, states = self.prefill(params, prompt_ids, states)
        v = last_logits.shape[-1]

        states = [tuple(x.repeat_interleave(w, dim=0) for x in s) for s in states]
        scores, tok0 = torch.topk(torch.log_softmax(last_logits, -1), w)  # [B, W]

        def body(states, preps, head, scores, tok):
            new_logits, new_states = self._token_step(params, preps, head, tok.reshape(b * w),
                                                      states)
            total = scores[:, :, None] + torch.log_softmax(new_logits, -1).reshape(b, w, v)
            top, flat = torch.topk(total.reshape(b, w * v), w)
            parent = flat // v
            rows = torch.arange(b, device=flat.device)[:, None]
            gather_idx = (parent + rows * w).reshape(-1)
            copy_tree(states, [tuple(x[gather_idx] for x in s) for s in new_states])
            scores.copy_(top)
            tok.copy_(flat % v)
            return tok, parent

        key = ("beam", b, w, last_logits.dtype)
        step = self._step(self._graphs, key, params,
                          self._tensors(params, states, scores=scores, tok=tok0.clone()), body,
                          tok0.device)
        toks = torch.empty((max(steps - 1, 0), b, w), dtype=torch.long, device=tok0.device)
        parents = torch.empty_like(toks)
        for i in range(steps - 1):
            toks[i], parents[i] = step.run()
        scores = step.tensors["scores"].clone()

        beam_idx = torch.arange(w, device=prompt_ids.device).expand(b, w)
        out = []
        for tok, parent in zip(reversed(toks), reversed(parents)):
            out.append(tok.gather(1, beam_idx))
            beam_idx = parent.gather(1, beam_idx)
        out.append(tok0.gather(1, beam_idx))
        tokens = torch.stack(out[::-1])
        if length_penalty:
            scores = scores / (float(steps) ** length_penalty)
        return tokens, scores
