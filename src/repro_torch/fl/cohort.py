"""Cohort execution engine: the K clients of a window as one batched program.

Port of ``repro.fl.cohort`` on one device.  The simulator's event heap
decides *when* each client's round runs in simulated time; this module
decides *how* the card executes the work.  Instead of K serial
``train_local`` / ``evaluate`` / ``signature`` calls, a
:class:`CohortBackend` keeps the K clients' parameter trees stacked along a
leading client axis (``tree_stack``) and runs local training as one batched
program over them, and validation and signatures as one call each that
runs the K forwards back to back.

The batched programs come per backend family from a suite
(:class:`CohortPrograms`):

  * :class:`CNNCohortPrograms`, the paper's VGG path.  Its training runs
    each conv layer of the K clients as one grouped convolution
    (``groups=K``) and each dense layer as one batched product, the
    counterpart of the reference's ``vmap`` of a ``scan``.  The
    reference's im2col products (``_conv_as_matmul``), its form for a
    ``vmap`` that XLA:CPU lowers well, are slower on the card than
    cuDNN's grouped convolutions (``chip_smoke.py`` times both).
    Validation and signatures keep the conv-form forward (``models.cnn``)
    per client, the counterpart of ``lax.map``; the signatures'
    per-sample rows come from the Eq. 3 signature kernel
    (``ops.signature_per_channel``), one launch per client.
  * :class:`LMCohortPrograms`, the ``LMBackend`` path (the dense GQA
    decoders, Jamba's hybrid, xLSTM, the MoE models).  Its training is
    ``torch.func.vmap`` of the model's functional ``loss_fn`` over the
    stacked tree (the reference's ``vmap``), on the plain attention and
    the models' own scans under autograd; validation and signatures run
    per client on the kernels, the signature rows from one kernel launch
    over the client's final-norm output (``per_sample_signature``).

Either way the sum of the K clients' losses is backpropagated once, so
each client's gradient is exactly its own loss's.
``register_cohort_programs`` extends the registry; a backend without a
suite runs sequentially (``build_cohort_engine`` returns None).

Ragged shards are handled by padding and masking, as in the reference:

  * training: every client's step sequence is padded to the window's
    longest; a padded step computes a gradient on zero padding, and the
    client's parameters and momentum rows are restored after the update,
    so padding never leaks into the trained weights;
  * validation and signatures: sample axes are padded to the window's
    largest shard and the accuracy and Eq. 3 means are masked.

The reference pads the client axis to powers of two, sample axes to
multiples of ``eval_pad_quantum`` and the step axis to a monotone target,
to bound XLA's compiled programs.  The port compiles nothing and pads to
the window's own sizes; masked rows add exact zeros, so the results are
the padded reference's.

Means over a window are true float32 divisions, as the reference's
cohort programs compute them (``num / max(den, 1)``), not the multiply by
a float32 reciprocal that its jitted ``jnp.mean`` (and the sequential
path, ``core.aggregate.f32_mean``) uses: the two differ in the last bit on
many counts, and these means reach the Eq. 7 digest and tip selection.
An LM row's token accuracy is a mean over its unpadded positions inside
the reference's jitted program, so it multiplies by the float32
reciprocal.  Those accuracies and the LM signature rows are not exact
sums in every order (the CNN's 0/1 counts and k/1024 fractions are), so
the LM suite adds a window's rows as the reference's programs add them on
the CPU, over the rows the reference pads a shard to
(:func:`_lane_sum`, :func:`_fused_row_sum`).

The scenarios' update transform (``perturb_update``,
``perturb_cohort_stacked_trees``, ``CohortBackend.perturb_cohort_stacked``)
lives here as in the reference: ``agg + gamma*(new - agg) + sigma*N(0,
I)`` over a window's stacked leaves, with the reference's fused
multiply-adds (``core.aggregate.fma_f32``) and DP noise from
``torch.Generator`` (the reference's ``jax.random`` bits cannot be drawn
here, so the noise matches in distribution only).

Over a device mesh (``repro_torch.launch.mesh``) one controller drives
every device, as the reference's ``shard_map`` does: the stacked client
axis is padded to a multiple of the ``clients`` axis (repeats of the last
client, discarded) and cut into contiguous groups, and each group runs the
single-device programs above on its own device, with no exchange inside a
window.  Launches are asynchronous, so the devices work at once; results
are read only after every group has launched.  On a 2-D (clients, data)
mesh each group's training batch (and its validation and signature
samples) also splits over the ``data`` axis: every device of a group
holds the group's models, computes the sum-form loss or metric terms of
its slice, and the terms are added over the group's devices, in device
order on its first one (the reference's ``lax.psum``), before the one
division and the one update; the other devices take copies of the
updated models, so the replicas stay bit-identical.  A 1x1 mesh is the
single-device engine.  There is no kernel policy: the tensors' device
decides, as everywhere in the port.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import List, Optional, Sequence, Type

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.aggregate import (TREE_WINDOW, add_in_order,
                                        axis_devices, block_slices,
                                        f32_mean, fma_f32, input_row_sum,
                                        next_pow2, ordered_sum, pad_leading,
                                        round_up_multiple, split_blocks,
                                        tree_leaves, tree_map, tree_stack,
                                        tree_unstack)
from repro_torch.data.pipeline import WindowAssembler
from repro_torch.fl.backend import CNNBackend, LMBackend
from repro_torch.kernels import ops
from repro_torch.models import transformer as tfm
from repro_torch.optim.optimizers import apply_updates
from repro_torch.runtime import Runtime, on_device


def _pad_rows(tree, target: int):
    """Pad every leaf's leading axis to ``target`` rows with repeats of its
    last row (the reference's cohort padding; those rows are discarded)."""
    def pad(leaf):
        reps = target - leaf.shape[0]
        if reps <= 0:
            return leaf
        return torch.cat([leaf, leaf[-1:].expand((reps,) + leaf.shape[1:])])
    return tree_map(pad, tree)


def _client(tree, k: int):
    """Client ``k``'s tree: views of row ``k`` of every stacked leaf."""
    return tree_map(lambda leaf: leaf[k], tree)


def _tree_select(done: Sequence[int], leaves: Sequence[torch.Tensor],
                 old: Sequence[torch.Tensor]) -> None:
    """Identity step for the masked clients: rows ``done`` of the stacked
    ``leaves``, just updated in place, are put back to ``old`` (their
    copies from before the step, client by client).  The reference's
    ``where(keep, new, old)`` over whole trees, by rows."""
    rows = iter(old)
    for k in done:
        for leaf in leaves:
            leaf[k].copy_(next(rows))


# -- scenario update transforms (see fl/scenarios.py) -------------------------
#
#   new' = agg + gamma * (new - agg) + sigma * N(0, I)
#
# gamma = scale_gamma < 0 is scaled-gradient model poisoning, gamma = 0 is a
# free-rider republishing the aggregate, sigma > 0 is DP noise.  gamma=1 /
# sigma=0 is the identity only algebraically, so callers skip unaffected
# dispatches entirely and the stacked form re-selects unaffected rows'
# original bits.  The products are fused into their sums (``fma_f32``), as
# XLA compiles the reference's jitted transform.  The reference's program
# is fused by XLA, not a Pallas kernel: plain tensor operations port it.


def _perturb_generators(seed: int, client: int, seq: int, n_leaves: int,
                        device) -> tuple:
    """The noise streams of one (scenario seed, client, per-client update
    seq), the reference's ``_perturb_key``: one ``torch.Generator`` on
    ``device`` and its key split leaf by leaf (as ``jax.random.split``):
    one seed per leaf, in ``tree_leaves`` order, that the generator takes
    before it draws that leaf's noise.  The same streams
    for the single and the stacked form, so they agree bit for bit; the
    draws are not ``jax.random``'s, so the noise matches the reference's
    in distribution only."""
    seeds = np.random.SeedSequence((int(seed), int(client), int(seq))
                                   ).generate_state(n_leaves, np.uint64)
    gen = torch.Generator(device=device)
    return gen, [int(s) for s in seeds]


def perturb_cohort_stacked_trees(agg_stacked, new_stacked, plan: dict):
    """Whole-window transform over the stacked K-client trees: row k takes
    ``plan``'s row k (gamma, sigma, noise stream), then a per-leaf select
    restores the rows the plan marks unaffected to their exact bits (fault
    injection must not perturb honest clients).  Integer leaves pass
    through untouched."""
    new_leaves = tree_leaves(new_stacked)
    agg_leaves = tree_leaves(agg_stacked)
    k = new_leaves[0].shape[0]
    dev = new_leaves[0].device
    gammas = torch.as_tensor(np.asarray(plan["gammas"], np.float32),
                             device=dev)
    sigmas = np.asarray(plan["sigmas"], np.float32)
    keep = torch.as_tensor(np.asarray(plan["affected"], bool), device=dev)
    noisy = [r for r in range(k) if sigmas[r] > 0]
    streams = {r: _perturb_generators(plan["seed"], plan["clients"][r],
                                      plan["seqs"][r], len(new_leaves), dev)
               for r in noisy}
    sig_rows = torch.as_tensor(sigmas, device=dev)
    out = []
    for i, (new, agg) in enumerate(zip(new_leaves, agg_leaves)):
        if not new.is_floating_point():
            out.append(new)
            continue
        rows = (k,) + (1,) * (new.dim() - 1)
        v = fma_f32(gammas.view(rows), new - agg, agg)
        if noisy:
            noise = torch.zeros_like(v)
            for r in noisy:
                gen, seeds = streams[r]
                noise[r].normal_(generator=gen.manual_seed(seeds[i]))
            sig = sig_rows.view(rows)
            v = torch.where(sig > 0, fma_f32(sig, noise, v), v)
        out.append(torch.where(keep.view(rows), v, new))
    leaves = iter(out)
    return tree_map(lambda _: next(leaves), new_stacked)


def perturb_update(agg, new, plan: dict, k: int):
    """Apply row ``k`` of a :meth:`repro_torch.fl.scenarios.Scenario.
    update_plan` to one trained model (the sequential path and windows of
    one): the stacked form on a window of one."""
    row = {key: np.asarray(plan[key])[k:k + 1]
           for key in ("clients", "seqs", "gammas", "sigmas", "affected")}
    one = perturb_cohort_stacked_trees(
        tree_map(lambda leaf: leaf[None], agg),
        tree_map(lambda leaf: leaf[None], new),
        {"seed": plan["seed"], **row})
    return tree_map(lambda leaf: leaf[0], one)


def _grouped_conv(x: torch.Tensor, w: torch.Tensor,
                  b: torch.Tensor) -> torch.Tensor:
    """K clients' SAME-padding stride-1 convolutions as one grouped
    convolution: x (B, K*cin, H, W), client k's channels in group k;
    w (K, kh, kw, cin, cout) HWIO; b (K, cout) -> (B, K*cout, H, W).  The
    same contraction as K convolutions, in another summation order."""
    k, kh, kw, cin, cout = w.shape
    weight = w.permute(0, 4, 3, 1, 2).reshape(k * cout, cin, kh, kw)
    return F.conv2d(x, weight, b.reshape(-1), padding="same", groups=k)


def _masked_terms(rows: torch.Tensor, ms: torch.Tensor):
    """(sum of the rows whose mask is 1, their count): the reference's
    ``sum(z * w, 0)`` and ``sum(w)``."""
    w = ms[:, None]
    return (rows * w).sum(dim=0), w.sum()


def _divide(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """A window mean from its sum-form terms: a true float32 division by
    ``max(den, 1)``, as the reference's cohort programs divide."""
    return num / den.clamp_min(1.0)


def _masked_mean(rows: torch.Tensor, ms: torch.Tensor) -> torch.Tensor:
    """Mean of the rows whose mask is 1, by a true division (the
    reference's ``sum(z * w, 0) / max(sum(w), 1)``)."""
    return _divide(*_masked_terms(rows, ms))


def _reference_rows(n: int) -> int:
    """The rows the reference engine pads a shard of ``n`` to
    (``_round_chunk`` at its default quantum of 64): the padded rows are
    zeros in its sums and change their order."""
    return next_pow2(n) if n < 64 else round_up_multiple(n, 64)


def _join_lanes(acc: torch.Tensor) -> torch.Tensor:
    """A vectorized loop's lanes (L, ...), L a power of two, added in
    halves."""
    while acc.shape[0] > 1:
        half = acc.shape[0] // 2
        acc = acc[:half] + acc[half:]
    return acc[0]


def _lane_sum(z: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Float32 sum along ``dim`` of rows computed in the program
    (accuracies), in the order of the reference's jitted LM programs on
    XLA:CPU (jaxlib 0.9.0 on x86-64 with AVX-512), over the rows padded to
    ``_reference_rows``: probed at every count from 1 to 130 and at ten
    counts from 200 to 5,000; other jaxlib versions or CPUs are
    unverified.

    Up to 32 rows (a power of two), one vectorized loop: lane ``j`` of
    ``min(n, 8)`` lanes adds rows ``j, j + lanes, ...``, and the lanes are
    joined in halves.  Past 32 rows, the order of rows that are a program
    input (``core.aggregate.input_row_sum``): the window sums are the next
    fusion's input."""
    rows = z.movedim(dim, 0)
    rows = pad_leading(rows, _reference_rows(rows.shape[0]))
    n = rows.shape[0]
    if n > TREE_WINDOW:
        return input_row_sum(rows)
    return _join_lanes(ordered_sum(rows.unflatten(0, (-1, min(n, 8)))))


def _fused_row_sum(counts: torch.Tensor, scale: torch.Tensor
                   ) -> torch.Tensor:
    """``sum_i counts[i] * scale[i]`` over rows (n, d) of exact counts, in
    the order of the reference's masked signature mean on XLA:CPU (probed
    at every count from 1 to 69 and at five counts to 300): up to 32
    padded rows, each product is fused into the sum, one fused
    multiply-add (``fma_f32``) a row in 8 lanes joined in halves; past
    32, the rounded products as ``_lane_sum`` adds them."""
    n = _reference_rows(counts.shape[0])
    if n > TREE_WINDOW:
        return _lane_sum(counts * scale[:, None])
    rows = round_up_multiple(n, 8)
    counts = pad_leading(counts, rows).unflatten(0, (-1, 8))
    scale = pad_leading(scale, rows).unflatten(0, (-1, 8))[..., None]
    acc = torch.zeros_like(counts[0])
    for c, w in zip(counts, scale):
        acc = fma_f32(w.expand_as(c), c, acc)
    return _join_lanes(acc)


# ---------------------------------------------------------------------------
# per-backend cohort program suites
# ---------------------------------------------------------------------------


class CohortPrograms:
    """Batched train/eval/signature program suite for one backend family.

    :class:`CohortBackend` supplies the execution discipline (stacking,
    padding, masking, the optimizer loop) and delegates everything
    backend-specific to this interface.  A suite owns:

    on the device:
      * ``sum_loss(stacked, x, y, w, denom)``  (K,) training losses of K
        stacked models, each on its own batch x (K, B, ...): row-weighted
        loss sums over ``denom``, so that all-ones ``w`` and ``denom =
        loss_denom(w, y)`` give each client's mean loss (the reference's
        sum form, which its data-mesh engine sums across devices)
      * ``loss_denom(w, y)``  the count in loss units for row weights ``w``
      * ``eval_terms(params, xs, ys, ms)``  (num, den) masked-accuracy terms
        of one model on one shard; ``masked_eval`` = num / max(den, 1)
      * ``eval_shared_terms(params, x, y, mask)``  (num (K,), den (K,))
        terms for ONE model on K stacked shards
      * ``sample_signature(params, xs)``  per-sample Eq. 3 signature rows,
        so the engine can take a padding-masked mean
      * ``signature_terms(params, xs, ms)``  (num, den) of that mean (by
        default the masked sum of ``sample_signature``'s rows);
        ``signature_mean`` = num / max(den, 1)

    on the host (batch assembly, matching the sequential RNG streams):
      * ``client_batches(ds, seed, epochs)``  numpy (xb (T, ...), yb (T, ...))
      * ``eval_single(ds, limit, kind)``  numpy (x (n, ...), y, n) for one
        shard; ``kind`` is "eval" or "sig"
      * ``summarize_losses(losses, steps, epochs)``  the sequential path's
        per-client loss contract
      * ``evaluate_one(params, ds, limit)``  sequential single-model eval
        (the small-M path of ``evaluate_many``)
    """

    backend_cls: Type = None
    # up to this many candidate models, evaluate_many runs the sequential
    # per-model program (and its mean); more take the masked mean
    eval_many_min_batch: int = 1

    def __init__(self, backend):
        self.backend = backend
        self.cfg = backend.cfg

    @property
    def default_epochs(self) -> int:
        raise NotImplementedError

    def sum_loss(self, stacked, x, y, w, denom):
        raise NotImplementedError

    def loss_denom(self, w, y):
        raise NotImplementedError

    def eval_terms(self, params, xs, ys, ms):
        raise NotImplementedError

    def eval_shared_terms(self, params, x, y, mask):
        raise NotImplementedError

    def masked_eval(self, params, xs, ys, ms):
        """Masked accuracy on one shard: the sum-form terms, then a true
        division."""
        return _divide(*self.eval_terms(params, xs, ys, ms))

    def eval_shared(self, params, x, y, mask):
        """ONE model on K stacked shards, via the sum-form terms."""
        return _divide(*self.eval_shared_terms(params, x, y, mask))

    def sample_signature(self, params, xs):
        raise NotImplementedError

    def signature_terms(self, params, xs, ms):
        """(num (dims,), den) of the masked signature mean."""
        return _masked_terms(self.sample_signature(params, xs), ms)

    def signature_mean(self, params, xs, ms):
        return _divide(*self.signature_terms(params, xs, ms))

    def client_batches(self, ds, seed: int, epochs: int):
        raise NotImplementedError

    def eval_single(self, ds, limit: int, kind: str):
        raise NotImplementedError

    def summarize_losses(self, losses: np.ndarray, steps: Sequence[int],
                         epochs: int) -> List[float]:
        raise NotImplementedError

    def evaluate_one(self, params, ds, limit: int) -> float:
        raise NotImplementedError


class CNNCohortPrograms(CohortPrograms):
    """VGG-family programs (the paper's experimental setup).

    Training runs the K stacked clients' forward as one program of grouped
    convolutions; validation and signatures keep the conv-form forward per
    client.
    """

    backend_cls = CNNBackend

    @property
    def default_epochs(self) -> int:
        return self.backend.local_epochs

    def _stacked_forward(self, stacked, x):
        """``cnn_forward`` of K stacked models as one program: x (K, B, H,
        W, C) -> logits (K, B, n_classes).  The K clients' feature maps
        ride side by side in the channels of one (B, K*C, H, W)
        channels-last tensor, so each conv layer is one grouped
        convolution (:func:`_grouped_conv`) and each pooling one call; the
        last map is split back per client and flattened in NHWC order, and
        the dense layers are batched products."""
        k, b, hh, ww, c = x.shape
        x = x.permute(1, 2, 3, 0, 4).reshape(b, hh, ww, k * c)
        x = x.permute(0, 3, 1, 2)            # NCHW view, channels-last
        for stack_params in stacked["convs"]:
            for p in stack_params:
                x = torch.relu(_grouped_conv(x, p["w"], p["b"]))
            x = F.max_pool2d(x, 2)
        _, kc, hh, ww = x.shape
        x = x.permute(0, 2, 3, 1).reshape(b, hh, ww, k, kc // k)
        x = x.permute(3, 0, 1, 2, 4).reshape(k, b, -1)
        for p in stacked["fcs"][:-1]:
            x = torch.relu(torch.baddbmm(p["b"][:, None], x, p["w"]))
        p = stacked["fcs"][-1]
        return torch.baddbmm(p["b"][:, None], x, p["w"])

    def sum_loss(self, stacked, x, y, w, denom):
        """(K,) row-weighted cross-entropy sums over ``denom``, each client
        on its own batch."""
        logits = self._stacked_forward(stacked, x)
        logz = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, y.long()[..., None])[..., 0]
        return ((logz - ll) * w).sum(dim=-1) / denom

    def loss_denom(self, w, y):
        return w.sum()

    def eval_terms(self, params, xs, ys, ms):
        """Masked #correct terms on one shard, conv-form forward."""
        from repro_torch.models import cnn as cnn_mod
        logits, _ = cnn_mod.cnn_forward(params, xs, self.cfg)
        correct = (logits.argmax(-1) == ys).float()
        return (correct * ms).sum(), ms.sum()

    def eval_shared_terms(self, params, x, y, mask):
        """ONE model on K padded shards (the publisher's monitor): the K
        shards fold into the batch dimension of one conv-form forward."""
        from repro_torch.models import cnn as cnn_mod
        k, n = y.shape
        logits, _ = cnn_mod.cnn_forward(params, x.flatten(0, 1), self.cfg)
        correct = (logits.argmax(-1).reshape(k, n) == y).float() * mask
        return correct.sum(dim=1), mask.sum(dim=1)

    def sample_signature(self, params, x):
        """Per-sample Eq. 3 zero fractions (N, channels), conv-form, with an
        early exit: only the convs up to ``signature_layer`` run.  The rows
        come from the signature kernel, one launch."""
        cfg = self.cfg
        x = x.permute(0, 3, 1, 2)            # NCHW view, channels-last
        conv_idx = 0
        for stack_params in params["convs"]:
            for p in stack_params:
                x = F.conv2d(x, p["w"].permute(3, 2, 0, 1), padding="same")
                x = F.relu(x + p["b"][:, None, None])
                if conv_idx == cfg.signature_layer:
                    return ops.signature_per_channel(x.permute(0, 2, 3, 1),
                                                     tau=0.0)
                conv_idx += 1
            x = F.max_pool2d(x, 2)
        raise ValueError(f"signature_layer {cfg.signature_layer} out of "
                         f"range for {cfg.name}")

    def client_batches(self, ds, seed: int, epochs: int):
        """``CNNBackend.train_local``'s exact batches: the same numpy RNG
        stream per seed."""
        rng = np.random.default_rng(seed)
        xs, ys = zip(*(self.backend._batches(ds, rng) for _ in range(epochs)))
        return np.concatenate(xs), np.concatenate(ys)

    def eval_single(self, ds, limit: int, kind: str):
        n = min(len(ds), limit)
        return ds.x[:n], ds.y[:n], n

    def summarize_losses(self, losses, steps, epochs) -> List[float]:
        """Sequential contract: mean loss over the client's LAST epoch."""
        per_epoch = [s // epochs for s in steps]
        return [float(np.mean(losses[i, s - per_epoch[i]:s]))
                for i, s in enumerate(steps)]

    def evaluate_one(self, params, ds, limit: int) -> float:
        return self.backend.evaluate(params, ds, limit)


class LMCohortPrograms(CohortPrograms):
    """``LMBackend`` programs: the dense GQA decoders, Jamba's hybrid,
    xLSTM and the MoE models.

    Training is ``torch.func.vmap`` of the model's functional ``loss_fn``
    over the K stacked trees, each client on its own token batch, on the
    plain attention and the models' own scans under autograd (the kernels
    have no backward, as in the reference); the vmapped products run as
    batched ones.  Validation and signatures run per client on the
    kernels, as the reference's ``lax.map``.  Token batches are drawn on
    the host with ``LMBackend``'s numpy RNG streams, so cohort and
    sequential runs see the same tokens.  Signatures are the Eq. 3
    threshold fractions of the final-norm output, per sample
    (``tfm.per_sample_signature``), so the engine's mask keeps padded rows
    out of the mean.
    """

    backend_cls = LMBackend
    eval_many_min_batch = 3
    # sequential LMBackend.evaluate/signature fix their sampling seeds
    _EVAL_SEEDS = {"eval": 1, "sig": 2}

    def __init__(self, backend):
        super().__init__(backend)
        # eval and signature forwards take the kernels; the rows' tau and
        # width come from the backend's signature runtime
        self.runtime = backend.eval_runtime
        self.sig_runtime = backend.signature_runtime
        # the batched training drops remat, as the reference's engine
        # does: a checkpoint's backward would recompute outside the vmap
        self.train_runtime = Runtime(remat=False)

    @property
    def default_epochs(self) -> int:
        return self.backend.local_steps

    def sum_loss(self, stacked, x, y, w, denom):
        """(K,) row-weighted token cross-entropy over the token count
        ``denom``: x (K, B, S+1) token rows, y (K, B, S) = x[..., 1:]."""
        m = w[:, None].expand(y.shape[1:]).float()

        def one(params, xk, yk):
            batch = {"tokens": xk[:, :-1], "labels": yk, "mask": m}
            return tfm.loss_fn(params, batch, self.cfg,
                               self.train_runtime)[0]

        return torch.func.vmap(one)(stacked, x, y) * m.sum() / denom

    def loss_denom(self, w, y):
        return w.sum() * y.shape[-1]

    def _row_correct(self, params, xs, ys):
        """(N, S) correctness grid of a token shard."""
        logits, _ = tfm.forward(params, {"tokens": xs[:, :-1]}, self.cfg,
                                self.runtime, mode="prefill")
        return (logits.argmax(-1) == ys).float()

    def _row_accuracy(self, params, xs, ys):
        """(N,) next-token accuracy of each row: a mean over its S
        positions, by the float32 reciprocal."""
        return f32_mean(self._row_correct(params, xs, ys), dim=-1)

    def eval_terms(self, params, xs, ys, ms):
        """Rows all carry ``seq_len`` real positions, so the masked mean of
        row means is the sequential path's grand mean."""
        per_row = self._row_accuracy(params, xs, ys)
        return _lane_sum(per_row * ms), ms.sum()

    def eval_shared_terms(self, params, x, y, mask):
        """ONE model on K stacked token shards, folded into the batch of
        one forward."""
        k, n = x.shape[:2]
        per_row = self._row_accuracy(params, x.flatten(0, 1),
                                     y.flatten(0, 1)).reshape(k, n)
        return _lane_sum(per_row * mask, dim=1), mask.sum(dim=1)

    def _hidden(self, params, xs):
        return tfm.forward_hidden(params, {"tokens": xs[:, :-1]}, self.cfg,
                                  self.runtime, mode="prefill")[0]

    def sample_signature(self, params, xs):
        """(N, signature_dims) Eq. 3 rows of the final-norm output."""
        return tfm.per_sample_signature(self._hidden(params, xs),
                                        self.sig_runtime)

    def signature_terms(self, params, xs, ms):
        """The masked sum of the rows, from their exact bucket counts (one
        kernel launch) in the reference's fused order, and the count."""
        rt = self.sig_runtime
        sums, scale = ops.signature_buckets(
            self._hidden(params, xs), tau=rt.signature_tau,
            n_sig=rt.signature_dims)
        return _fused_row_sum(sums, ms * scale), ms.sum()

    def client_batches(self, ds, seed: int, epochs: int):
        """``LMBackend.train_local``'s stream: one ``_sample`` call drawing
        (epochs, B, S+1) token windows."""
        toks = self.backend._sample(ds, np.random.default_rng(seed), epochs)
        return toks, toks[:, :, 1:]

    def eval_single(self, ds, limit: int, kind: str):
        toks = self.backend._sample(ds, np.random.default_rng(
            self._EVAL_SEEDS[kind]), 1)[0]
        return toks, toks[:, 1:], int(toks.shape[0])

    def summarize_losses(self, losses, steps, epochs) -> List[float]:
        """Sequential contract: mean loss over ALL the client's steps."""
        return [float(np.mean(losses[i, :s])) for i, s in enumerate(steps)]

    def evaluate_one(self, params, ds, limit: int) -> float:
        return self.backend.evaluate(params, ds)


_PROGRAM_REGISTRY: List[Type[CohortPrograms]] = []


def register_cohort_programs(programs_cls: Type[CohortPrograms]) -> None:
    """Register a program suite; later registrations win on overlap."""
    if not isinstance(getattr(programs_cls, "backend_cls", None), type):
        raise TypeError(
            f"{programs_cls.__name__}.backend_cls must name the backend "
            "class the suite batches for")
    _PROGRAM_REGISTRY.insert(0, programs_cls)


register_cohort_programs(CNNCohortPrograms)
register_cohort_programs(LMCohortPrograms)


def _programs_for(backend) -> Optional[Type[CohortPrograms]]:
    for cls in _PROGRAM_REGISTRY:
        if isinstance(backend, cls.backend_cls):
            return cls
    return None


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


class CohortBackend:
    """Batched train/eval/signature over a stacked K-client tree, on the
    backend's device or over a device mesh.  The backend-specific programs
    come from the :class:`CohortPrograms` registry.

    ``mesh`` is a :class:`~repro_torch.launch.mesh.Mesh` with a
    ``clients_axis`` axis (and optionally ``data_axis``); one of a single
    device is the single-device engine.  Results return to the backend's
    device."""

    def __init__(self, backend, mesh=None, clients_axis: str = "clients",
                 data_axis: str = "data", eval_cache_entries: int = 64,
                 overlap: bool = True):
        programs_cls = _programs_for(backend)
        if programs_cls is None:
            raise TypeError(
                f"no CohortPrograms registered for {type(backend).__name__}; "
                f"known: {[c.backend_cls.__name__ for c in _PROGRAM_REGISTRY]}")
        self.programs = programs_cls(backend)
        self.backend = backend
        self.device = backend.device
        self.cfg = backend.cfg
        self.opt = backend.opt
        # LRU over eval/signature shards on the device: a long-running
        # simulator sweeps many shards; the cap bounds the memory they hold
        self._eval_data_cache: "OrderedDict" = OrderedDict()
        self.eval_cache_entries = max(int(eval_cache_entries), 1)
        # a 1x1 (or absent) mesh is the single-device engine: a grid of
        # one device, which every program below runs over
        self.clients_axis = clients_axis
        self.data_axis = data_axis
        self.mesh = None
        self._grid = np.asarray([[self.device]], dtype=object)
        if mesh is not None:
            if clients_axis not in mesh.shape:
                raise ValueError(
                    f"mesh axes {tuple(mesh.axis_names)} carry no "
                    f"{clients_axis!r} axis")
            n_clients = int(mesh.shape[clients_axis])
            n_data = int(mesh.shape.get(data_axis, 1))
            if n_clients > 1 or n_data > 1:
                self.mesh = mesh
                axes = (clients_axis,) + ((data_axis,) if n_data > 1 else ())
                self._grid = np.asarray(axis_devices(mesh, axes),
                                        dtype=object).reshape(n_clients,
                                                              n_data)
        self._n_shards, self._n_data = self._grid.shape
        # host-side window assembly: prefetched on a background thread, or
        # inline when overlap is off
        self.assembler = WindowAssembler(self.programs, self._grid,
                                         overlap=overlap)

    @staticmethod
    def supports(backend) -> bool:
        return _programs_for(backend) is not None

    def _cohort_target(self, k: int) -> int:
        """Client-axis pad target: a multiple of the clients axis under a
        mesh, so that the groups divide evenly."""
        return round_up_multiple(k, self._n_shards)

    def _groups(self, n: int):
        """(rows, devices) of each client group over an axis of ``n``
        padded rows."""
        return zip(block_slices(n, self._n_shards), self._grid)

    # -- batched programs ---------------------------------------------------

    def _train_group(self, stacked, xbs, ybs, bms, steps):
        """Local SGD of stacked clients over their batches ``xbs[d]`` (K, T,
        B_d, ...), one data slice per device, the first being the group's:
        one batched step per tick.  Each slice's sum-form loss uses the
        group's total row count, its gradients are added over the slices
        in device order on the first device, and the update is taken there;
        the other slices compute on copies of the updated models.  ``bms``
        weighs the slices' batch rows (None: every row counts).  A client
        whose steps have run out (``t >= steps[k]``) still computes on its
        zero padding, and its parameter and momentum rows are put back
        after the update, so masked steps keep the old state exactly (the
        optimizer advances its momentum in place).  Returns the trained
        tree and the (K, T) losses, both on the first device, without
        waiting for them."""
        dev = xbs[0].device
        params = tree_map(lambda p: p.detach().to(dev, copy=True)
                          .requires_grad_(True), stacked)
        opt_state = self.opt.init(params)
        state = tree_leaves(params) + tree_leaves(opt_state.get("mu", []))
        if bms is None:
            bms = [torch.ones(yb.shape[2], device=yb.device) for yb in ybs]
        denom = add_in_order([self.programs.loss_denom(bm, yb[0, 0])
                              for bm, yb in zip(bms, ybs)], dev)
        denoms = [denom.to(yb.device) for yb in ybs]
        losses = []
        for t in range(xbs[0].shape[1]):
            replicas = [params] + [
                tree_map(lambda p, d=xb.device: p.detach().to(d)
                         .requires_grad_(True), params) for xb in xbs[1:]]
            parts = []
            for rep, xb, yb, bm, den in zip(replicas, xbs, ybs, bms, denoms):
                with on_device(xb.device):
                    loss = self.programs.sum_loss(rep, xb[:, t], yb[:, t],
                                                  bm, den)
                    loss.sum().backward()
                parts.append(loss.detach())
            done = [k for k, s in enumerate(steps) if t >= s]
            with torch.no_grad():
                old = [leaf[k].clone() for k in done for leaf in state]
                grads = tree_map(lambda p: p.grad, params)
                for rep in replicas[1:]:
                    grads = tree_map(lambda g, r: g + r.grad.to(dev), grads,
                                     rep)
                updates, opt_state = self.opt.update(grads, opt_state, params)
                apply_updates(params, updates)
                _tree_select(done, state, old)
            del grads, updates, old      # not held through the next step
            for p in tree_leaves(params):
                p.grad = None
            losses.append(add_in_order(parts, dev))
        return tree_map(lambda p: p.detach(), params), torch.stack(losses, 1)

    def _train(self, stacked, win):
        """The window's local SGD: each client group on its devices
        (launched group after group, read once all are running), the trees
        gathered on the engine's device.  Returns the trained tree and
        (K, T) losses, 0 on masked steps."""
        k = len(win.steps)
        target = self._cohort_target(k)
        stacked = _pad_rows(stacked, target)
        steps = win.steps + [win.steps[-1]] * (target - k)
        runs = []
        for (rows, devices), part in zip(self._groups(target), win.parts):
            bms = None if win.bm is None else split_blocks(win.bm, devices)
            with on_device(devices[0]):
                runs.append(self._train_group(
                    tree_map(lambda leaf: leaf[rows], stacked),
                    [p[0] for p in part], [p[1] for p in part], bms,
                    steps[rows]))
        params = tree_map(lambda *ls: self._gather(ls)[:k],
                          *[r[0] for r in runs])
        losses = self._gather([r[1] for r in runs])[:k].cpu().numpy()
        losses[win.mask.numpy() == 0] = 0.0
        return params, losses

    def _gather(self, parts) -> torch.Tensor:
        """The groups' blocks joined on the engine's device (one group's
        block as it is)."""
        if len(parts) == 1:
            return parts[0].to(self.device)
        return torch.cat([p.to(self.device) for p in parts])

    def _eval_arrays(self, datasets: Sequence, limit: int,
                     kind: str = "eval"):
        """(x, y, mask) on the device for a tuple of shards, each padded to
        the call's largest (and, over a data axis, to a multiple of it).
        Per-dataset LRU cache of the unpadded shards: the monitor's full
        val-set sweep and a window's subset reuse the same buffers, and the
        cache stays bounded at ``eval_cache_entries``."""
        singles = []
        for ds in datasets:
            key = (id(ds), limit, kind)
            hit = self._eval_data_cache.get(key)
            if hit is None:
                x1, y1, n = self.programs.eval_single(ds, limit, kind)
                # hold ds so the id() key stays unique for our lifetime
                hit = (ds, torch.from_numpy(np.ascontiguousarray(x1))
                       .to(self.device),
                       torch.from_numpy(np.ascontiguousarray(y1))
                       .to(self.device), n)
                self._eval_data_cache[key] = hit
            else:
                self._eval_data_cache.move_to_end(key)
            singles.append(hit)
        # evict AFTER the batch, clamped to the call's own width, so that
        # one wide sweep cannot evict its own entries mid-call
        cap = max(self.eval_cache_entries, len(datasets))
        while len(self._eval_data_cache) > cap:
            self._eval_data_cache.popitem(last=False)
        target = round_up_multiple(max(s[3] for s in singles), self._n_data)
        x = torch.stack([pad_leading(s[1], target) for s in singles])
        y = torch.stack([pad_leading(s[2], target) for s in singles])
        rows = torch.arange(target, device=self.device)
        mask = torch.stack([(rows < s[3]).float() for s in singles])
        return x, y, mask

    def _per_client(self, fn, model, arrays, k: int):
        """``fn``'s (num, den) terms for models ``model(0..k-1)``, model
        ``j`` on row ``j`` of ``arrays`` (K, N, ...): client rows in groups
        (a padded row computes nothing), sample axes in data slices, the
        terms added over a group's devices before the division.  Returns
        the k results on the engine's device."""
        out = []
        for rows, devices in self._groups(self._cohort_target(k)):
            for j in range(rows.start, min(rows.stop, k)):
                params = model(j)
                terms = []
                for d, *cols in zip(devices, *(split_blocks(a[j], devices)
                                               for a in arrays)):
                    with on_device(d):
                        terms.append(fn(tree_map(lambda leaf: leaf.to(d),
                                                 params), *cols))
                num = add_in_order([t[0] for t in terms], devices[0])
                den = add_in_order([t[1] for t in terms], devices[0])
                out.append(_divide(num, den).to(self.device))
        return torch.stack(out)

    # -- public API ----------------------------------------------------------

    def prefetch_window(self, datasets: Sequence, seeds: Sequence[int],
                        epochs: Optional[int] = None) -> None:
        """Start assembling the given window's training batch on the
        assembler's background thread (sampling, stacking, padding, the
        copy to the card), so it overlaps whatever the card is running.
        The matching ``train_cohort_stacked`` collects it; a mismatched or
        absent prefetch assembles inline, with identical results."""
        self.assembler.prefetch(datasets, seeds,
                                epochs or self.programs.default_epochs,
                                self._cohort_target(len(datasets)))

    def train_cohort_stacked(self, stacked_params, datasets, seeds,
                             epochs: Optional[int] = None):
        """Train K clients as one program from ``stacked_params`` (left
        untouched); returns (stacked params, losses).  ``losses[k]`` matches
        the sequential path's contract (``summarize_losses``)."""
        epochs = epochs or self.programs.default_epochs
        k = tree_leaves(stacked_params)[0].shape[0]
        if k != len(datasets):
            raise ValueError(f"{k} stacked models for {len(datasets)} shards")
        win = self.assembler.take(datasets, seeds, epochs,
                                  self._cohort_target(k))
        new_params, losses = self._train(stacked_params, win)
        return new_params, self.programs.summarize_losses(losses, win.steps,
                                                          epochs)

    def train_cohort(self, params_list, datasets, seeds,
                     epochs: Optional[int] = None):
        stacked, losses = self.train_cohort_stacked(
            tree_stack(params_list), datasets, seeds, epochs)
        return tree_unstack(stacked), losses

    @torch.inference_mode()
    def evaluate_cohort_stacked(self, stacked_params, datasets,
                                limit: int = 512) -> List[float]:
        """K models, each on its own (ragged) shard, one after another."""
        x, y, mask = self._eval_arrays(datasets, limit)
        return self._per_client(self.programs.eval_terms,
                                lambda j: _client(stacked_params, j),
                                (x, y, mask), len(datasets)).cpu().tolist()

    def evaluate_cohort(self, params_list, datasets,
                        limit: int = 512) -> List[float]:
        return self.evaluate_cohort_stacked(tree_stack(params_list), datasets,
                                            limit)

    @torch.inference_mode()
    def evaluate_shared(self, params, datasets, limit: int = 512
                        ) -> List[float]:
        """One model on K shards in one forward (the publisher's monitor);
        over a mesh the model is copied to every device and the shards
        split in groups and data slices."""
        x, y, mask = self._eval_arrays(datasets, limit)
        k = len(datasets)
        target = self._cohort_target(k)
        x, y, mask = (pad_leading(a, target) for a in (x, y, mask))
        out = []
        for rows, devices in self._groups(target):
            terms = []
            for d, *cols in zip(devices, *(split_blocks(a[rows], devices, 1)
                                           for a in (x, y, mask))):
                with on_device(d):
                    terms.append(self.programs.eval_shared_terms(
                        tree_map(lambda leaf: leaf.to(d), params), *cols))
            num = add_in_order([t[0] for t in terms], devices[0])
            den = add_in_order([t[1] for t in terms], devices[0])
            out.append(_divide(num, den).to(self.device))
        return torch.cat(out)[:k].cpu().tolist()

    @torch.inference_mode()
    def evaluate_many(self, params_list, ds, limit: int = 512) -> List[float]:
        """M candidate models on one validation shard (tip selection).  Up
        to ``eval_many_min_batch`` models take the backend's own program
        and its mean; more take the masked mean, as in the reference.  Over
        a mesh the models split in groups and the shard is copied to every
        group (its samples split over a data axis)."""
        if len(params_list) <= self.programs.eval_many_min_batch:
            return [self.programs.evaluate_one(p, ds, limit)
                    for p in params_list]
        x, y, mask = self._eval_arrays([ds], limit)
        m = len(params_list)
        arrays = [a.expand((m,) + a.shape[1:]) for a in (x, y, mask)]
        return self._per_client(self.programs.eval_terms,
                                params_list.__getitem__, arrays, m
                                ).cpu().tolist()

    @torch.inference_mode()
    def signature_cohort_stacked(self, stacked_params, datasets,
                                 limit: int = 128) -> np.ndarray:
        """(K, dims) Eq. 3 signatures: per client, the per-sample rows (one
        kernel launch) and their masked mean."""
        x, _, mask = self._eval_arrays(datasets, limit, kind="sig")
        return self._per_client(self.programs.signature_terms,
                                lambda j: _client(stacked_params, j),
                                (x, mask), len(datasets)).cpu().numpy()

    def signature_cohort(self, params_list, datasets,
                         limit: int = 128) -> np.ndarray:
        return self.signature_cohort_stacked(tree_stack(params_list),
                                             datasets, limit)

    @torch.no_grad()
    def perturb_cohort_stacked(self, agg_stacked, new_stacked, plan: dict):
        """Scenario fault injection for a whole window (see
        fl/scenarios.py): ``new' = agg + gamma*(new-agg) + sigma*N`` over
        the stacked trees; rows the plan marks unaffected keep their exact
        bits."""
        return perturb_cohort_stacked_trees(agg_stacked, new_stacked, plan)


# ---------------------------------------------------------------------------
# engine construction (shared by the coordinator and all baselines)
# ---------------------------------------------------------------------------


def parse_mesh_spec(spec):
    """A mesh spec's (clients, data) request.  Accepts ``"auto"``,
    ``"CxD"`` strings (``"4x2"``, ``"8x1"``, ``"8"``), and 2-tuples whose
    clients slot may be ``"auto"`` (``("auto", 2)``, ``(4, 2)``)."""
    if isinstance(spec, str):
        parts = spec.lower().split("x")
        if len(parts) > 2 or not all(
                p == "auto" or p.isdigit() for p in parts):
            raise ValueError(
                f"mesh must be 'auto', 'CxD' (e.g. '4x2'), a (clients, "
                f"data) tuple, None or a Mesh: {spec!r}")
    elif isinstance(spec, (tuple, list)):
        parts = list(spec)
        if len(parts) != 2:
            raise ValueError(f"mesh tuple must be (clients, data): {spec!r}")
    else:
        raise TypeError(f"unsupported mesh spec: {spec!r}")
    clients = parts[0]
    data = int(parts[1]) if len(parts) > 1 else 1
    if clients != "auto":
        clients = int(clients)
    return clients, data


def resolve_cohort_mesh(mesh, cohort_size: int, clients_axis: str = "clients",
                        data_axis: str = "data", devices=None):
    """``"auto"`` -> a clients mesh clamped to the devices (never raises
    for lack of them; one device gives the single-device engine); ``"CxD"``
    (e.g. ``"4x2"``) or a ``(clients, data)`` tuple (clients may be
    ``"auto"`` -> ``cohort_size``) -> the 2-D (clients, data) mesh, clamped
    the same way; ``None`` -> single-device; a Mesh -> itself.  The devices
    are ``devices``, else the visible CUDA cards
    (``launch.mesh.make_cohort_mesh``)."""
    if mesh is None or hasattr(mesh, "axis_names"):
        return mesh
    clients, data = parse_mesh_spec(mesh)
    if clients == "auto":
        clients = cohort_size
    from repro_torch.launch.mesh import make_cohort_mesh
    return make_cohort_mesh(clients, axis=clients_axis, data=data,
                            data_axis=data_axis, devices=devices)


def build_cohort_engine(backend, *, cohort_size: int, mesh="auto",
                        clients_axis: str = "clients",
                        data_axis: str = "data",
                        overlap: bool = True) -> Optional[CohortBackend]:
    """The engine for any registered backend family: the mesh spec resolved
    (:func:`resolve_cohort_mesh`) over the backend's device when that is
    the CPU (one device: the single-device engine) and over the visible
    cards when it is a card.  ``None`` when cohort execution is off
    (``cohort_size <= 1``) or the backend has no registered program suite:
    callers then run the sequential path."""
    if cohort_size <= 1 or not CohortBackend.supports(backend):
        return None
    devices = None if backend.device.type == "cuda" else [backend.device]
    return CohortBackend(
        backend, overlap=overlap, clients_axis=clients_axis,
        data_axis=data_axis,
        mesh=resolve_cohort_mesh(mesh, cohort_size, clients_axis, data_axis,
                                 devices))
