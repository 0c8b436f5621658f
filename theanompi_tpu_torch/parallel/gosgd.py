"""GoSGD: randomized peer-to-peer gossip SGD (port of
``theanompi_tpu/parallel/gosgd.py``).

Theano-MPI's GoSGD rule (Blot et al. 2016): after a local step each
worker pushes, with probability ``p``, half its share weight and its
share-weighted params to a random peer, which merges by the
share-weighted average ``w ← (keep·w + a_s·w_s) / (keep + a_s)`` and
adds the received share. The shares sum to 1 over the workers at all
times; the consensus is ``Σ a_i·w_i``.

As in the reference, a round draws ONE shift ``s ∈ [1, n−1]`` shared by
every worker and an independent Bernoulli(p) push a worker: each worker
sends to the worker ``s`` ahead and receives from the worker ``s``
behind, in one ``batch_isend_irecv`` (``strategies._hop`` over the
worker axis); a worker that does not push still sends, its share 0, as
the reference's ``ppermute`` does. So each sender's peer is uniform over
the others, and each receiver gets at most one message a round (the
reference's documented departure from Theano-MPI, whose peers were
independent). One message a round: the params flattened in the
reference's ``ravel_pytree`` order and layouts, through
``codec.gossip_encode`` (int8: one quantize launch; the share travels
exact), decoded at the receiver (one dequantize launch); under ``:ef``
a pushing worker adds its flat residual ``[L]`` first and keeps what its
quantizer discarded, which it learns by decoding its own message (one
more dequantize launch, every round).

``p_push`` defaults to 0.25; ``avg_freq=k`` sets ``p = 1/k``.
``gossip_every=k`` runs a round after every k-th step only; the engine
counts steps on the host from the state's counter (a resumed state's
included). On one worker no round runs (the identity: no peer).
Validation runs on the consensus: ``Σ a_i·w_i`` by one ``all_reduce``
over the workers, the model state their mean.

Draws (``GossipDraws``): the shift from a host ``torch.Generator``
seeded alike on every rank, the push from one of the worker's (every
rank of a group draws the same). JAX keys and torch generators share no
bits, so the draws are a constructor argument (``draws``, any object
with ``draw(worker) -> (shift, push)``, ``get_state(worker)`` and
``set_state(row, worker)``): the parity tests feed the reference's own. Their state
goes into the checkpoint (``__torch_gossip_rng__``, one row a rank).
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from theanompi_tpu_torch import bridge
from theanompi_tpu_torch.parallel.codec import gossip_decode, gossip_encode
from theanompi_tpu_torch.parallel.distributed import all_gather_objects
from theanompi_tpu_torch.parallel.strategies import _hop, _pack_leaves, _unpack_leaves
from theanompi_tpu_torch.parallel.workers import WorkerRuleEngine
from theanompi_tpu_torch.train import TrainState
from theanompi_tpu_torch.tree import tree_leaves, tree_map

Tree = Any

GOSSIP_RNG_KEY = "__torch_gossip_rng__"


class GOSGDState(NamedTuple):
    worker: TrainState  # this rank's worker (the reference's row of its stack)
    alpha: torch.Tensor  # this worker's share weight, f32 scalar; sum over workers == 1
    # this worker's flat [L] residual of its gossip values (``()`` without one)
    ef: Any = ()


class GossipDraws:
    """The draws of the gossip rounds (module docstring): the shift from
    a generator seeded alike on every rank, the push from the worker's
    own. ``draw(worker)`` -> ``(shift in [1, n-1], push)``."""

    def __init__(self, seed: int, n_workers: int, p_push: float):
        self.n, self.p = int(n_workers), float(p_push)
        self.seed = int(seed)
        self.shift_gen = torch.Generator().manual_seed(self.seed * 1_000_003 + 1)
        self.push_gen: Optional[torch.Generator] = None

    def _push_gen(self, worker: int) -> torch.Generator:
        if self.push_gen is None:
            self.push_gen = torch.Generator().manual_seed(self.seed * 1_000_003 + 2 + worker)
        return self.push_gen

    def draw(self, worker: int) -> tuple:
        shift = int(torch.randint(1, self.n, (), generator=self.shift_gen))
        push = bool(torch.rand((), generator=self._push_gen(worker)) < self.p)
        return shift, push

    def get_state(self, worker: int) -> np.ndarray:
        """Both generators' states, one uint8 row."""
        return torch.cat([self.shift_gen.get_state(), self._push_gen(worker).get_state()]).numpy()

    def set_state(self, row: np.ndarray, worker: int) -> None:
        half = self.shift_gen.get_state().numel()
        state = torch.from_numpy(np.array(row, dtype=np.uint8))
        self.shift_gen.set_state(state[:half].clone())
        self._push_gen(worker).set_state(state[half:].clone())


class GOSGDEngine(WorkerRuleEngine):
    """Local steps, each followed by a gossip round on the
    ``gossip_every`` cadence (module docstring). ``p_push``: the push
    probability a round; ``avg_freq=k`` sets it to ``1/k``; ``seed`` seeds
    the default draws, ``draws`` replaces them. Other arguments:
    ``WorkerRuleEngine``'s."""

    name = "gosgd"

    def __init__(self, model, n_devices: int = 1, device=None, steps_per_epoch: int = 1,
                 p_push: float = 0.25, avg_freq: Optional[int] = None, gossip_every: int = 1,
                 seed: int = 0, draws=None, **kw):
        super().__init__(model, n_devices, device, steps_per_epoch, **kw)
        if avg_freq:  # the reference's configuration: p = 1/avg_freq
            p_push = 1.0 / avg_freq
        self.p_push = float(p_push)
        self.gossip_every = max(1, int(gossip_every))
        self.draws = draws if draws is not None else GossipDraws(seed, self.n_workers,
                                                                  self.p_push)
        self.use_ef = self.codec.active and self.codec.error_feedback

    def init_state(self, gen: torch.Generator) -> GOSGDState:
        """The worker from ``gen`` (every rank draws the same), the share
        ``1/n_workers``, a zero flat residual when the codec keeps one."""
        worker = self._init_worker(gen)
        self._count = None
        ef = ()
        if self.use_ef:
            n = sum(p.numel() for p in tree_leaves(worker.params))
            ef = torch.zeros(n, dtype=torch.float32, device=self.device)
        alpha = torch.full((), 1.0 / self.n_workers, dtype=torch.float32, device=self.device)
        return GOSGDState(worker=worker, alpha=alpha, ef=ef)

    def _comm_due(self, step: int) -> bool:
        return self.n_workers > 1 and step % self.gossip_every == 0

    def train_step(self, state: GOSGDState, images, labels, gen):
        """One local step, then a gossip round when the cadence says so."""
        if self._count is None:  # a fresh or resumed state: its own counter
            self._count = self.get_step(state)
        state, metrics = self._local(state, images, labels, gen)
        if self._comm_due(self._count):
            state = self._timed_comm(state)
        return state, metrics

    def exchange(self, state: GOSGDState) -> GOSGDState:
        return state  # the gossip runs inside the step

    def _comm(self, state: GOSGDState) -> GOSGDState:
        """One gossip round (module docstring)."""
        shift, push = self.draws.draw(self.worker)
        worker, codec = state.worker, self.codec
        leaves = tree_leaves(worker.params)
        tags = tree_leaves(self.model.param_layouts(worker.params))
        with torch.no_grad():
            flat = _pack_leaves(leaves, tags)
            n = flat.numel()
            send = state.alpha * 0.5 if push else torch.zeros_like(state.alpha)
            keep = state.alpha - send
            values = send * flat
            if self.use_ef:
                values = values + (state.ef if push else 0.0)
            message = gossip_encode(codec, values, send)
            recv_values, recv_share = gossip_decode(
                codec, _hop(message, self.n_workers, shift, self.worker_group), n)
            ef = state.ef
            if self.use_ef:
                # what this worker's quantizer discarded: its own message decoded
                sent, _ = gossip_decode(codec, message, n)
                ef = values - sent if push else state.ef
            share = keep + recv_share
            merged = (keep * flat + recv_values) / share
            for p, piece in zip(leaves, _unpack_leaves(merged, leaves, tags)):
                p.copy_(piece)
        return state._replace(alpha=share, ef=ef)

    def eval_step(self, state: GOSGDState, images, labels) -> dict:
        """Validation on the consensus ``Σ a_i·w_i`` (one ``all_reduce``
        over the workers) with the workers' mean model state."""
        worker = state.worker
        leaves = tree_leaves(worker.params)
        tags = tree_leaves(self.model.param_layouts(worker.params))
        with torch.no_grad():
            flat = state.alpha * _pack_leaves(leaves, tags)
            if self.n_workers > 1:
                torch.distributed.all_reduce(flat, group=self.worker_group)
            it = iter(_unpack_leaves(flat, leaves, tags))
            params = tree_map(lambda _: next(it), worker.params)
            ms = tree_leaves(worker.model_state)
            it = iter(self._worker_mean(ms))
            model_state = tree_map(lambda _: next(it), worker.model_state)
        return self._eval_on(params, model_state, worker.step, images, labels)

    def summary_fields(self, batch: int) -> dict:
        return {**super().summary_fields(batch), "p_push": self.p_push,
                "gossip_every": self.gossip_every}

    def rank_summary(self, state: GOSGDState) -> dict:
        """``WorkerRuleEngine``'s, and this worker's share."""
        return {**super().rank_summary(state), "alpha": float(state.alpha)}

    # -- the checkpoint: the reference's GOSGDState entries -------------------

    def state_entries(self, state: GOSGDState, layouts) -> Optional[dict]:
        """Rank 0: the entries of ``state`` as the reference's checkpoint
        of its ``GOSGDState`` holds them (``.workers/…`` and ``.alpha``
        stacked over the workers, ``.ef`` ``[n, L]``), plus every rank's
        draw generators under ``__torch_gossip_rng__``; None on the other
        ranks. Collective."""
        rows = self._worker_rows(state.worker._replace(ef=()))
        alphas = self._worker_rows(state.alpha)
        ef_rows = self._worker_rows(state.ef) if self.use_ef else None
        draws = all_gather_objects(self.draws.get_state(self.worker), self.n)
        if rows is None:
            return None
        entries = bridge.worker_entries(rows, layouts)
        entries[".alpha"] = torch.stack([a.to(alphas[0].device) for a in alphas])
        if ef_rows is not None:
            entries[".ef"] = torch.stack([e.to(ef_rows[0].device) for e in ef_rows])
        entries[GOSSIP_RNG_KEY] = np.stack(draws)
        return entries

    def checkpoint_parts(self, state: GOSGDState, layouts) -> list:
        """The entries of :meth:`state_entries` this rank holds, as
        ``(entry, tensor, row, rows)`` (``bridge.state_parts``), with no
        collective: its worker's rows and its draw generators' row."""
        row, n = self._own_row(), self.n_workers
        parts = bridge.worker_parts(state.worker, layouts, row, n)
        parts.append((".alpha", state.alpha.detach(), row, n))
        if self.use_ef:
            parts.append((".ef", state.ef.detach(), row, n))
        parts.append((GOSSIP_RNG_KEY, self.draws.get_state(self.worker), self.rank, self.n))
        return parts

    def elastic_spec(self) -> dict:
        """Reshard policies (the reference's ``GOSGDEngine.elastic_spec``):
        the worker stacks by ``worker_consensus``, the share weights
        restart at ``1 / W`` (``worker_uniform``, so they sum to 1 on the
        new world), the residuals ``reset``."""
        return {"policies": {".workers": {"policy": "worker_consensus"},
                             ".alpha": {"policy": "worker_uniform"},
                             ".ef": {"policy": "reset"}}}

    def restore(self, flat: dict, template: GOSGDState, layouts) -> GOSGDState:
        """This rank's state from checkpoint entries (its worker's row of
        each stack) and its draw generators when the file holds them of
        this run's ranks; raises naming the entry on a missing key or a
        stack of another worker count."""
        self._count = None
        w, n = self.worker, self.n_workers
        alpha = bridge.stacked_row(flat, ".alpha", template.alpha, w, n)
        ef = template.ef
        if self.use_ef:
            ef = bridge.stacked_row(flat, ".ef", template.ef, w, n)
        draws = flat.get(GOSSIP_RNG_KEY)
        if draws is not None and draws.shape[0] == self.n:
            self.draws.set_state(draws[self.rank], self.worker)
        elif self.rank == 0:
            print("[gosgd] the checkpoint holds no gossip draw state of this run's "
                  f"{self.n} ranks: the draws start from the seed", flush=True)
        return GOSGDState(worker=bridge.worker_from_flat(flat, template.worker, layouts, w, n),
                          alpha=alpha, ef=ef)
