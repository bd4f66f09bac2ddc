"""One device dispatch for many steps: a step captured once as a CUDA graph
and replayed (the port's counterpart of the JAX package's `jax.jit` over a
`lax.scan` of steps: `LMTrainer.fuse_chunks`, `HARTrainer.fuse_batches`,
the decoder's one-scan decode and beam search).

A `StepGraph` holds a step function that reads its inputs from static
tensors and carries its state in tensors it updates in place (parameters,
optimizer state, recurrent states, logits). Each call is one step:

  * the first `WARMUP` calls run the step eagerly on the graph's own side
    stream, as PyTorch's CUDA-graph notes ask: they load every kernel
    library (`ops._build`) and make every lazy allocation before capture.
    They are real steps, so nothing has to be undone after them;
  * the next call captures the step (`torch.cuda.graph`) on that stream,
    with every explicit `torch.Generator` the step draws from registered
    (`CUDAGraph.register_generator_state`), then replays it; every later
    call replays it. A replay draws the same dropout masks, negatives and
    samples as the eager step from the same generator state, and advances
    the generator as far.

A call copies its arguments into the static inputs first. The step's
outputs are tensors of the graph's memory pool, overwritten by the next
replay: read or copy them before the next call.

`CarriedSteps` is the trainers' form: a step over one row of stacked
inputs whose recurrent states stay in static tensors from one step to the
next (`LMTrainer._fused_chunks` and `_eval_chunks`, `HARTrainer.
_fused_steps`, `SparseSampledTrainer.fused_chunks`); `steps_eagerly` runs
the same step without a graph, on the CPU.

A step may run `torch.distributed` collectives over NCCL (the trainers under
a mesh: the gradient and loss sums over ``data``, the split vocabulary's
over ``model``, the ranker's broadcast of the negatives): they are captured
into the graph with the rest of the step, and each replay runs them again,
so every rank of a group must replay its graph as often as the others. NCCL
makes a group's communicator at that group's first collective, which
capture cannot hold: the warm-up steps run the step's every collective
first, so every group the captured step uses has its communicator.

The launch counters of the kernel wrappers (`ops.cuda_scan.COUNTED`) stay
the number of kernels that ran: capture runs nothing, so what it counted is
taken back, and each replay adds the launches that capture counted.

CUDA only: a CPU device raises, and so does any error of capture or replay.
There is no fallback to the eager step on the card.
"""

from __future__ import annotations

import collections
import contextlib
import gc
import time

import torch

from vmlmf_tpu_torch.ops.cuda_scan import COUNTED
from vmlmf_tpu_torch.utils.tree import tree_leaves

WARMUP = 2  # eager steps on the side stream before capture


def _counts():
    return [(fn.launches, collections.Counter(fn.variants)) for fn in COUNTED]


def on_card(device):
    """Whether steps on ``device`` run as captured graphs: on CUDA."""
    return torch.device(device).type == "cuda"


def copy_tree(dst, src):
    """Copy each tensor of the tree ``src`` into the tensor at its place in
    ``dst`` (a step's static tensors), where the two are not one storage."""
    for a, b in zip(tree_leaves(dst), tree_leaves(src)):
        if torch.is_tensor(a) and a.data_ptr() != b.data_ptr():
            a.copy_(b)


def graph_key(leaves, *shaped):
    """What a captured step depends on besides its inputs' values: the shapes
    of ``shaped`` and the dtypes and storage of the ``leaves`` it reads."""
    return (tuple(tuple(a.shape) for a in shaped), tuple(p.dtype for p in leaves),
            tuple(p.data_ptr() for p in leaves))


class StepGraph:
    """``step(*inputs) -> tuple of tensors``, captured on CUDA and replayed.

    ``inputs``: example tensors, copied into the graph's static inputs (the
    step reads those). ``generators``: the `torch.Generator`s the step
    draws from. ``device``: where the step runs, a CUDA device.
    """

    def __init__(self, step, inputs=(), *, device, generators=()):
        device = torch.device(device)
        if not on_card(device) or not all(on_card(a.device) for a in inputs):
            raise ValueError("StepGraph captures CUDA work; CPU tensors run the eager step")
        if any(g is not None and g.device.type != "cuda" for g in generators):
            raise ValueError("a generator of a captured step must live on the CUDA device")
        self.step = step
        self.device = device
        self.inputs = tuple(a.clone() for a in inputs)
        self.generators = tuple(g for g in generators if g is not None)
        self.stream = torch.cuda.Stream(device)
        self.graph = None
        self.outputs = None
        self.capture_seconds = None
        self.pool_bytes = None  # device memory the capture reserved for the graph's pool
        self._warm = 0
        self._launches = None  # (wrapper, launches, variants) of one replay

    def __call__(self, *values):
        if len(values) != len(self.inputs):
            raise TypeError(f"the step takes {len(self.inputs)} inputs, got {len(values)}")
        for buf, v in zip(self.inputs, values):
            if buf is not v:
                buf.copy_(v)
        if self.graph is None and self._warm < WARMUP:
            self._warm += 1
            return self._on_stream(lambda: self.step(*self.inputs))
        if self.graph is None:
            self._capture()
        self.graph.replay()
        for fn, n, variants in self._launches:
            fn.launches += n
            fn.variants.update(variants)
        return self.outputs

    @property
    def captured(self):
        return self.graph is not None

    def _on_stream(self, fn):
        """fn() on the graph's side stream, ordered after and before the
        current stream's work."""
        current = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            out = fn()
        current.wait_stream(self.stream)
        return out

    def _capture(self):
        graph = torch.cuda.CUDAGraph()
        for g in self.generators:
            graph.register_generator_state(g)
        before = _counts()
        # a graph that the collector frees during the capture (steps and their
        # owners hold each other) would end it: collect first, then hold off
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        t0 = time.perf_counter()
        try:
            with torch.cuda.graph(graph, stream=self.stream):
                reserved = torch.cuda.memory_reserved(self.device)
                outputs = self.step(*self.inputs)
        finally:
            if collecting:
                gc.enable()
        self.capture_seconds = time.perf_counter() - t0
        self.pool_bytes = torch.cuda.memory_reserved(self.device) - reserved
        self._launches = [(fn, fn.launches - n, fn.variants - variants)
                          for fn, (n, variants) in zip(COUNTED, before) if fn.launches > n]
        for fn, (n, variants) in zip(COUNTED, before):  # capture ran nothing
            fn.launches = n
            fn.variants.clear()
            fn.variants.update(variants)
        self.graph, self.outputs = graph, outputs


@contextlib.contextmanager
def drawing_from(own, generator):
    """A block of a graph's steps, which draw from the graph's ``own``
    generator, run from ``generator``'s state, and leave ``generator`` where
    they leave ``own``: as if they had drawn from ``generator`` itself. So
    the generator is a value of each call, as the JAX package's key is, and
    a new one captures nothing."""
    if generator is None or own is generator:
        yield
        return
    own.set_state(generator.get_state())
    yield
    generator.set_state(own.get_state())


class CarriedSteps:
    """``step(states, generator, *inputs) -> (new_states, *outputs)`` as one
    `StepGraph` whose recurrent states stay in static tensors from step to
    step, so that none leaves the device: the step reads them, and its new
    states are copied into them. A call runs one step per row of its stacked
    inputs.

    ``states``: example states (a tree of tensors; ``[]`` carries none);
    ``inputs``: an example row of each stacked input; ``draws``: the step
    draws from a generator (the graph's own, `drawing_from` the caller's).
    """

    def __init__(self, step, states, inputs, *, device, draws=False):
        self.states = [tuple(s.detach().clone() for s in st) for st in states]
        self.generator = torch.Generator(device) if draws else None

        def body(*row):
            new, *outputs = step(self.states, self.generator, *row)
            copy_tree(self.states, new)
            return tuple(outputs)

        self.graph = StepGraph(body, inputs, device=device, generators=(self.generator,))

    def __call__(self, states, generator, *stacks):
        """Steps from ``states`` over the rows of ``stacks``, drawing from
        ``generator`` -> (the last states, copies; each output stacked over
        the rows)."""
        copy_tree(self.states, states)
        outputs = None
        with drawing_from(self.generator, generator):
            for i in range(len(stacks[0])):
                row = self.graph(*(s[i] for s in stacks))
                if outputs is None:
                    outputs = [torch.empty((len(stacks[0]), *o.shape), dtype=o.dtype,
                                           device=o.device) for o in row]
                for out, o in zip(outputs, row):
                    out[i] = o
        return [tuple(s.clone() for s in st) for st in self.states], outputs


def steps_eagerly(step, states, generator, *stacks):
    """`CarriedSteps`' call without a graph, for the CPU: ``step``
    on each row in turn -> (the last states, each output stacked)."""
    outputs = []
    for row in zip(*stacks):
        states, *outs = step(states, generator, *row)
        outputs.append(outs)
    return states, [torch.stack(o) for o in zip(*outputs)]
