"""Autoregressive serving for the LM: prefill, stateful decode, sampling and
beam search (counterpart of `vmlmf_tpu.serve.decoder`).

  * prefill — the prompt ``[T, B]`` runs through the model's scan backend
    (on "fused", one kernel call per layer; on "fused_pipelined", one call
    of the no-grad stack kernel per group of layers) and returns the carried
    ``(h, c)`` per layer and the last position's logits.
  * decode — a loop over new positions: embed one token, run each layer's
    ``cell.step`` on factors whose weight-only ``prepare`` is done once per
    call, not per token, project to logits, pick the next token.
  * sampling — greedy (``temperature=None``), temperature, and ``top_k``;
    randomness from an explicit `torch.Generator` on the logits' device.

Everything runs under `torch.inference_mode`.
"""

from __future__ import annotations

import dataclasses

import torch


def _top_k_mask(logits, k):
    """Keep the k largest logits per row, set the rest to the dtype's min."""
    thresh = torch.topk(logits, k, dim=-1).values[..., -1:]
    neg = torch.finfo(logits.dtype).min
    return torch.where(logits < thresh, torch.full_like(logits, neg), logits)


@dataclasses.dataclass(frozen=True)
class Decoder:
    """Serving wrapper over an `LMModel`."""

    model: object  # LMModel

    def _preps(self, params):
        return tuple(cell.prepare(p) for cell, p in zip(self.model.rnn.cells, params["rnn"]))

    def _token_step(self, params, preps, tok, states):
        """One decode position: tok [B] -> (logits [B, V], new states)."""
        x = self.model.embed(params["embed"], tok)
        new_states = []
        for cell, prep, s in zip(self.model.rnn.cells, preps, states):
            s, x = cell.step(prep, cell.inp(prep, x), s)
            new_states.append(s)
        return self.model._logits(params, x), new_states

    @torch.inference_mode()
    def prefill(self, params, ids, states):
        """Consume the prompt. ids [T, B] -> (last logits [B, V], states)."""
        x, states = self.model.apply_hidden(params, ids, states, train=False)
        return self.model._logits(params, x[-1]), states

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
        preps = self._preps(params)
        logits, states = last_logits, list(states)
        tokens = []
        for _ in range(steps):
            if greedy:
                tok = torch.argmax(logits, dim=-1)
            else:
                lg = _top_k_mask(logits, top_k) if top_k is not None else logits
                probs = torch.softmax(lg / temperature, dim=-1)
                tok = torch.multinomial(probs, 1, generator=generator).squeeze(-1)
            logits, states = self._token_step(params, preps, tok, states)
            tokens.append(tok)
        tokens = torch.stack(tokens) if tokens else torch.empty(
            (0, last_logits.shape[0]), dtype=torch.long, device=last_logits.device)
        if return_logits:
            return tokens, states, logits
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
        preps = self._preps(params)
        v = last_logits.shape[-1]
        rows = torch.arange(b, device=prompt_ids.device)[:, None]

        states = [tuple(x.repeat_interleave(w, dim=0) for x in s) for s in states]
        scores, tok0 = torch.topk(torch.log_softmax(last_logits, -1), w)  # [B, W]
        tok, toks, parents = tok0, [], []
        for _ in range(steps - 1):
            logits, states = self._token_step(params, preps, tok.reshape(b * w), states)
            total = scores[:, :, None] + torch.log_softmax(logits, -1).reshape(b, w, v)
            scores, flat = torch.topk(total.reshape(b, w * v), w)
            parent, tok = flat // v, flat % v
            gather_idx = (parent + rows * w).reshape(-1)
            states = [tuple(x[gather_idx] for x in s) for s in states]
            toks.append(tok)
            parents.append(parent)

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
