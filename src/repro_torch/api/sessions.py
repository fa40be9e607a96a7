"""Sessions: one object per execution mode, all driven by one RunSpec
(port of ``repro/api/sessions.py``).

:class:`ServeSession` owns what the serving launcher used to assemble by
hand: it resolves the spec, checks ``kernels.policy`` against the device,
builds the engine (``ServingEngine.from_spec``: monolithic, or paged with
``serving.pages``), submits the reference's synthetic requests or drains
a restored snapshot, and returns the engine summary with the canonical
spec embedded (``spec`` / ``spec_hash`` / ``provenance``).  Its prompts
are the reference's, bit for bit: ``randint(PRNGKey(seed), (batch,
prompt_len), 0, vocab)``, each later batch under ``fold_in(key, chunk)``,
drawn by the numpy threefry of :mod:`repro_torch.api.threefry`.

``serving.static=true`` runs the pre-engine static path (one batch,
prefill once, ``gen`` decode steps), the oracle the engine is held
against; an encoder-decoder (whisper-medium) always takes it, as in the
reference, and ``serving.int8_cache`` is served there.  Its greedy
tokens are the reference's; sampled static tokens come from the port's
own per-request draws (``serving.engine``'s ``sample_token``: request
``seed + row``, draw ``1 + step``), as the engine's sampled decode does.
A VLM's requests carry the reference's synthetic image prefixes
(``threefry.normal_bf16`` under each prompt's key).

``device`` is not a spec field and never enters a hash: ``"cuda"`` (the
default) runs the CUDA kernels and raises without a card, ``"cpu"`` the
plain versions.  The policy must name what runs there (:func:`check_policy`).

:class:`TrainSession` is the reference's training loop: the
reference's token stream (``SyntheticLMStream``, bit for bit),
``init_train_state`` from the seed (the port's own init, on ``device``),
``CheckpointManager`` resume (a checkpoint the reference's session wrote
resumes here), and the step loop under the spans ``train.step``,
``train.step.data``, ``train.step.device`` (synchronised when telemetry is
on) and ``train.step.host``, with the straggler watchdog; its result has
the reference's keys.  Its ``kernels.policy`` and ``sparsity.backward``
must name what runs on ``device``, and a policy that pins
``flash_attention`` is refused on the card, whose kernel has no gradient.
``DryrunSession`` keeps the run-mode check; its spec's ``resolve()``
raises (the dry run has no twin, ROADMAP §1 item 5).

An explicit ``shape.mesh`` (``pod*data*model > 1``) builds its mesh over
the ranks of the process group (:func:`build_mesh`; one process per
rank, e.g. under ``torchrun``), and every rank runs the session: with
``data > 1`` training exchanges its gradients through the packed
collectives (``dist.train``) and the static serving path shards its
request rows (``dist.serve``), each adding a ``collective_probe`` to its
result; the engine runs replicated on every rank.  With ``model > 1`` and
``data == 1`` the dense family, olmoe, deepseek, mamba2 and recurrentgemma
run tensor parallel (the experts, the SSM's heads and the RG-LRU's channels
split over ``model`` too) in training, on the static path and through the
engines (``dist.tensor``; the paged pool refuses the recurrent archs, as
unsharded): the session shards given parameters at build time
(``runtime.tree_sharding.shard_tree``) or draws the rank's shards leaf by
leaf (``lm_init(..., mesh=)``), each rank holds its shards of the
parameters and moments (an engine also the pool of its kv heads and its
part of the recurrent state; an MLA arch's latent pool and mamba2's conv
state are whole on every rank), a checkpoint is written whole (gathered over ``model``, rank 0 writing the
reference's names) and resumed by slicing, and the result's
``tensor_parallel`` says what the rank held and how many collectives it
joined; pruning takes the whole weight's threshold.  The other archs and
``data > 1`` keep ``model`` replicated.  A named kind alone
(``shape.mesh=debug``) builds no mesh and runs unsharded, as in the
reference.  On the card each rank takes its own card where there are
enough, else they share one (:func:`repro_torch.dist.mesh.rank_device`).
"""

from __future__ import annotations

import logging
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import telemetry
from repro_torch.api import threefry
from repro_torch.api.spec import RunSpec, SpecError, build_spec


class Session:
    """Base: resolve the spec once, expose the reproducibility payload."""

    run_mode: str = ""

    def __init__(self, spec: RunSpec):
        if self.run_mode and spec.run != self.run_mode:
            raise SpecError(
                f"{type(self).__name__} needs a run={self.run_mode!r} spec, "
                f"got run={spec.run!r}")
        self.spec = spec
        self.resolved = spec.resolve()

    def trace_path(self) -> str:
        """Effective Chrome-trace output path ('' = telemetry off); an
        enabled spec with no explicit path still writes a trace."""
        t = self.spec.telemetry
        if not t.enabled:
            return ""
        return t.trace_path or f"spring_{self.spec.run}_trace.json"

    def telemetry_scope(self):
        """Ambient spring-trace scope for this run (no-op when disabled),
        written to :meth:`trace_path` on exit."""
        t = self.spec.telemetry
        cfg = telemetry.TelemetryConfig(
            enabled=t.enabled, trace_path=self.trace_path(),
            sample_rate=t.sample_rate)
        return telemetry.scope(cfg, metadata={
            "run": self.spec.run, "spec_hash": self.spec.spec_hash()})

    def _mesh_and_device(self, mesh, device) -> None:
        """Build the spec's explicit mesh unless the caller passed one, and
        pick this rank's device (the mesh's card on the card)."""
        from repro_torch.serving.engine import resolve_device

        device = resolve_device(device)
        if mesh is None and self.spec.shape.mesh.explicit:
            mesh = build_mesh(self.spec.shape.mesh, device=device)
        self.mesh = mesh
        mesh_dev = getattr(mesh, "device", None)
        self.device = mesh_dev if mesh_dev is not None and mesh_dev.type == device.type \
            else device

    def _tensor_parallel(self) -> bool:
        """Does this run split the weights over ``model``?"""
        from repro_torch.models.lm import tensor_parallel

        return tensor_parallel(self.resolved.config, self.mesh)

    def _shard(self, tree):
        """This rank's shards of a whole parameter (or moment) tree."""
        from repro_torch.runtime.sharding import sharding_context
        from repro_torch.runtime.tree_sharding import shard_tree

        with sharding_context(self.mesh):
            return shard_tree(tree, self.mesh)

    def _tp_report(self, params, cache=None) -> dict:
        """What a tensor-parallel rank held and did: its parameter bytes
        (the sum of its shards'), the collectives it joined over ``model``,
        the card tensors it staged through the host, its peak; given its
        serving ``cache``, the bytes of its recurrent state leaves there
        (``serving.kvpool.state_bytes``)."""
        from repro_torch.optim.optimizers import tree_leaves

        dev = self.device
        out = {"model": int(self.mesh.shape["model"]), "rank": self.mesh.axis_index("model"),
               "param_bytes": sum(p.numel() * p.element_size() for p in tree_leaves(params)),
               "model_hops": self.mesh.hops.get("model", 0),
               "staged_hops": self.mesh.staged_hops,
               "peak_bytes": torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0}
        if cache is not None:
            from repro_torch.serving.kvpool import state_bytes

            out["state_bytes"] = state_bytes(cache)
        return out

    def _with_payload(self, out: dict) -> dict:
        out.update(self.spec.payload())
        if self.spec.telemetry.enabled:
            tr = telemetry.tracer()
            out["telemetry"] = {
                "metrics": telemetry.metrics().snapshot(),
                "trace_path": self.trace_path(),
                "sample_rate": self.spec.telemetry.sample_rate,
                "spans": len(tr) if tr is not None else 0,
            }
        return out


log = logging.getLogger("repro_torch.train")


class TrainSession(Session):
    """End-to-end LM training: data -> train step -> checkpoint -> resume,
    with the straggler watchdog and the loss log.  ``params`` default to
    ``lm_init(cfg, seed)`` on ``device``; given ones are trained in place
    (the step donates its state).  Every LM arch trains but
    whisper-medium and internvl2-26b, which the spec refuses as the
    reference's session cannot train them (their frames / image prefix go
    through ``make_train_step``)."""

    run_mode = "train"

    def __init__(self, spec: RunSpec, *, params: Optional[dict] = None, device="cuda",
                 mesh=None):
        super().__init__(spec)
        check_policy(self.resolved.kernel_policy, device)
        check_backward(spec.sparsity.backward, device)
        if torch.device(device).type == "cuda" and self.resolved.step.attention == "flash":
            raise SpecError(
                f"kernels.policy={self.resolved.kernel_policy.describe()!r} pins "
                "flash_attention, whose card kernel has no gradient: a train step on "
                "'cuda' takes the chunked attention (leave flash_attention unpinned)")
        self._mesh_and_device(mesh, device)
        self.params = params

    def run(self) -> dict:
        with self.telemetry_scope():
            return self._run_body()

    def _run_body(self) -> dict:
        from repro_torch.checkpoint import CheckpointManager
        from repro_torch.convert import train_state_from_flat, train_state_to_flat
        from repro_torch.data.pipeline import DataConfig, SyntheticLMStream
        from repro_torch.dist.mesh import is_rank0
        from repro_torch.runtime.resilience import StragglerWatchdog
        from repro_torch.runtime.train import init_train_state, make_train_step

        spec, r = self.spec, self.resolved
        cfg, step_cfg, view = r.config, r.step, r.view
        seed, device = spec.seeds.seed, self.device
        if device.type == "cuda":
            # Q4.16 values carry 21 significant bits; TF32 keeps 11
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False

        data = SyntheticLMStream(DataConfig(
            seed=seed, vocab=cfg.vocab, seq_len=spec.shape.seq,
            global_batch=spec.shape.batch), device=device)
        tp = self._tensor_parallel()
        if tp:
            # this rank's shards: of the given parameters, or drawn leaf by
            # leaf (a rank never holds the whole tree)
            from repro_torch.models.lm import lm_init

            params = (self._shard(self.params) if self.params is not None
                      else lm_init(cfg, seed, device=device, mesh=self.mesh))
            state = init_train_state(params, step_cfg, seed, device=device)
        else:
            state = init_train_state(view if self.params is None else self.params, step_cfg,
                                     seed, device=device)
        start_step = 0

        # a mesh's ranks hold one state: rank 0 writes it (gathered whole
        # over model first, which every rank joins)
        manager = (CheckpointManager(spec.train.ckpt_dir, every_steps=spec.train.ckpt_every,
                                     writer=is_rank0())
                   if spec.train.ckpt_dir else None)
        to_flat = ((lambda: train_state_to_flat(self._gather_state(state), cfg)) if tp
                   else (lambda: train_state_to_flat(state, cfg)))
        if manager is not None:
            restored = manager.restore_or_none()
            if restored is not None:
                start_step, flat = restored
                state = train_state_from_flat(flat, cfg, device=device, like=state)
                if tp:  # a whole checkpoint, resumed by slicing
                    state = self._shard_state(state)
                log.info("resumed from step %d", start_step)
            if not is_rank0() and not tp:
                manager = None

        sharded = spec.shape.mesh.data > 1 and self.mesh is not None
        if sharded:
            # packed-collective data parallelism: the gradients cross the wire
            # binary-mask compressed, the losses stay the unsharded run's
            from repro_torch.dist.train import make_sharded_train_step

            step_fn = make_sharded_train_step(view, step_cfg, self.mesh)
        else:
            step_fn = make_train_step(view, step_cfg, mesh=self.mesh)
        watchdog = StragglerWatchdog()
        losses = []
        steps = spec.train.steps
        meta = {"arch": spec.arch.id, "mode": spec.numerics.mode,
                "spec_hash": spec.spec_hash()}
        for step in range(start_step, steps):
            with telemetry.span("train.step", step=step):
                with telemetry.span("train.step.data"):
                    tokens = data.batch(step)
                watchdog.step_start()
                with telemetry.span("train.step.device"):
                    state, metrics = step_fn(state, {"tokens": tokens})
                    if telemetry.enabled():
                        # the device's work inside the device span, so the
                        # host span times host work only
                        _sync(device)
                with telemetry.span("train.step.host"):
                    loss = float(metrics["loss"])
                    watchdog.step_end(step)
                    losses.append(loss)
                    if step % spec.train.log_every == 0 or step == steps - 1:
                        log.info("step %d loss %.4f grad_norm %.3f", step, loss,
                                 float(metrics["grad_norm"]))
                    if manager is not None:
                        manager.maybe_save(step + 1, to_flat, meta)
        if manager is not None:
            manager.maybe_save(steps, to_flat, meta, force=True)
        out = {
            "first_loss": losses[0] if losses else None,
            "last_loss": losses[-1] if losses else None,
            "losses": losses,
            "slow_steps": sum(1 for e in watchdog.events if e.slow),
            "state": state,
            "mesh": spec.shape.mesh.label(),
        }
        if sharded:
            # the wire accounting of one packed exchange at the probe density
            from repro_torch.dist.collectives import collective_probe

            out["collective_probe"] = collective_probe(
                spec.sparsity.probe_density, world=spec.shape.mesh.data, device=device)
        if tp:
            out["tensor_parallel"] = self._tp_report(state.params)
        return self._with_payload(out)

    def _shard_state(self, state):
        """This rank's shards of a whole train state."""
        import dataclasses

        opt = state.opt_state
        return dataclasses.replace(
            state, params=self._shard(state.params),
            opt_state=type(opt)(opt.step, self._shard(opt.m), self._shard(opt.v)))

    def _gather_state(self, state):
        """The whole train state, gathered over ``model`` on every rank."""
        import dataclasses

        from repro_torch.runtime.sharding import sharding_context
        from repro_torch.runtime.tree_sharding import gather_tree, param_splits

        with sharding_context(self.mesh):
            splits = param_splits(self.resolved.config, self.mesh)
        opt = state.opt_state
        return dataclasses.replace(
            state, params=gather_tree(state.params, self.mesh, splits),
            opt_state=type(opt)(opt.step, gather_tree(opt.m, self.mesh, splits),
                                gather_tree(opt.v, self.mesh, splits)))


class DryrunSession(Session):
    """The dry run lowers XLA programs and has no twin (ROADMAP §1 item 5):
    its spec's ``resolve()`` raises."""

    run_mode = "dryrun"


# -- serving ----------------------------------------------------------------

#: the policy names each device honours: on the card the port runs its
#: CUDA kernels (the counterparts of the reference's Pallas kernels), on
#: the CPU their plain versions (the reference's ref / jnp lowerings)
DEVICE_IMPLS = {"cuda": ("auto", "pallas"), "cpu": ("auto", "ref", "jnp")}


def check_policy(policy, device) -> None:
    """Raise :class:`SpecError` unless every implementation ``policy``
    names runs on ``device``: a spec must not ask for the plain oracle and
    get the kernel, or the other way round."""
    kind = torch.device(device).type
    allowed = DEVICE_IMPLS.get(kind, ("auto",))
    for op, name in (("", policy.default),) + tuple(policy.overrides):
        if name not in allowed:
            what = f"{op}={name}" if op else name
            raise SpecError(
                f"kernels.policy={policy.describe()!r}: {what!r} cannot run on "
                f"device {kind!r}, which honours {allowed} (the card runs the "
                "CUDA kernels, 'pallas'; the CPU their plain versions, 'ref' / "
                "'jnp'; 'auto' takes what the device runs)")


def check_backward(backward: str, device) -> None:
    """Raise :class:`SpecError` unless ``sparsity.backward`` runs on
    ``device``: "none" and "auto" anywhere; an implementation pin only
    where ``kernels.policy`` would honour that name (:data:`DEVICE_IMPLS`)."""
    kind = torch.device(device).type
    allowed = DEVICE_IMPLS.get(kind, ("auto",))
    if backward not in ("none", "auto") and backward not in allowed:
        raise SpecError(
            f"sparsity.backward={backward!r} cannot run on device {kind!r}, which "
            f"honours {allowed} (the card runs the backward kernels, 'pallas'; the CPU "
            "their plain versions, 'ref' / 'jnp')")


def synthetic_batch(arch, cfg, batch: int, prompt_len: int, key) -> dict:
    """The serving sessions' stand-in traffic, bit-equal to the reference's
    ``synthetic_batch`` under the same threefry ``key``: ``"tokens"``
    (batch, prompt_len) int32, with an encoder-decoder's ``"frames"``
    (batch, enc_seq, d) or a VLM's ``"img_embeds"`` (batch, prefix, d),
    bf16 CPU tensors drawn under the same key (``threefry.normal_bf16``)."""
    out = {"tokens": threefry.randint(key, (batch, prompt_len), 0, cfg.vocab)}
    if arch.is_encdec:
        out["frames"] = threefry.normal_bf16(key, (batch, cfg.enc_seq, cfg.d_model))
    elif cfg.vlm_prefix_len:
        out["img_embeds"] = threefry.normal_bf16(key, (batch, cfg.vlm_prefix_len, cfg.d_model))
    return out


def synthetic_prompts(n_requests: int, batch: int, prompt_len: int, vocab: int,
                      seed: int) -> list:
    """The engine session's ``n_requests`` prompts: batches of ``batch``,
    the first under ``PRNGKey(seed)``, batch ``c`` under ``fold_in(key,
    c)`` (distinct prompts, reproducible)."""
    key = threefry.prng_key(seed)
    prompts: list = []
    for chunk in range((n_requests + batch - 1) // batch):
        k = threefry.fold_in(key, chunk) if chunk else key
        prompts += threefry.randint(k, (batch, prompt_len), 0, vocab).tolist()
    return prompts[:n_requests]


def synthetic_images(n_requests: int, batch: int, prefix_len: int, d_model: int,
                     seed: int) -> list:
    """The image prefixes of :func:`synthetic_prompts`' requests, (prefix_len,
    d_model) bf16 each, drawn under the same keys as their prompts (the
    reference's ``synthetic_batch``)."""
    key = threefry.prng_key(seed)
    images: list = []
    for chunk in range((n_requests + batch - 1) // batch):
        k = threefry.fold_in(key, chunk) if chunk else key
        images += list(threefry.normal_bf16(k, (batch, prefix_len, d_model)))
    return images[:n_requests]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class ServeSession(Session):
    """One-shot serving session: the continuous-batching engine, or with
    ``serving.static`` the pre-engine static path kept as the parity
    oracle.  ``params`` default to ``lm_init(cfg, seed)`` on ``device``."""

    run_mode = "serve"

    def __init__(self, spec: RunSpec, *, params: Optional[dict] = None,
                 prune_ratio: float = 0.0, device="cuda", mesh=None):
        super().__init__(spec)
        check_policy(self.resolved.kernel_policy, device)
        self._mesh_and_device(mesh, device)
        self.params = params
        # magnitude pruning of the dense projections (the reference's
        # step_cfg.prune_ratio, which no spec field sets)
        self.prune_ratio = prune_ratio

    def run(self) -> dict:
        with self.telemetry_scope():
            if self.spec.serving.static or self.resolved.arch.is_encdec:
                # encoder-decoder archs keep the static loop, as in the reference
                return self._with_payload(self._static())
            return self._with_payload(self._engine())

    def _static(self) -> dict:
        """One fixed batch, prefill once, decode ``gen`` steps, throw the
        cache away (the reference's ``_static``).  An encoder-decoder never
        calls the prefill step: the cache is ``encdec_init_cache`` of the
        frames under a default (dense) ``SpringContext`` with ``prompt_len +
        gen`` self rows, and decoding starts from the prompt's first token,
        as the reference's does.  ``serving.int8_cache`` keeps the
        full-attention caches as int8 lines."""
        from repro_torch.models import encdec as ed_mod
        from repro_torch.models.layers import SpringContext
        from repro_torch.models.lm import lm_init, pad_cache
        from repro_torch.serving.engine import sample_token
        from repro_torch.serving.steps import make_decode_step, make_prefill_step

        spec, r = self.spec, self.resolved
        cfg, seed, encdec = r.config, spec.seeds.seed, r.arch.is_encdec
        batch, prompt_len, gen = (spec.shape.batch, spec.shape.prompt_len,
                                  spec.shape.gen)
        tp = self._tensor_parallel()
        if self.params is not None:  # under tp, this rank's shards of them
            params = self._shard(self.params) if tp else self.params
        elif encdec:
            params = ed_mod.encdec_init(cfg, seed, device=self.device)
        else:  # under tp, this rank's shards, drawn leaf by leaf
            params = lm_init(cfg, seed, device=self.device, mesh=self.mesh)
        inputs = {name: torch.as_tensor(t).to(self.device) for name, t in synthetic_batch(
            r.arch, cfg, batch, prompt_len, threefry.prng_key(seed)).items()}
        tokens = inputs["tokens"].to(torch.int64)
        int8 = spec.serving.int8_cache
        sharded = spec.shape.mesh.data > 1 and self.mesh is not None and not encdec
        if sharded and batch % spec.shape.mesh.data:
            # indivisible request batch: replicate instead of sharding, and
            # say so through the fallback counter the logical rules use
            from repro_torch.runtime.sharding import note_mesh_fallback

            note_mesh_fallback("serve_batch")
            sharded = False
        if sharded:
            # rows sharded over the data axis, logits packed on the wire
            from repro_torch.dist.serve import make_sharded_decode_step, make_sharded_prefill_step

            prefill = make_sharded_prefill_step(cfg, r.spring, self.mesh, int8, self.prune_ratio)
            decode = make_sharded_decode_step(cfg, r.spring, self.mesh, int8, self.prune_ratio)
        else:
            prefill = make_prefill_step(cfg, r.spring, int8, self.prune_ratio)
            decode = make_decode_step(cfg, r.spring, int8, self.prune_ratio)
        if tp:  # the steps run under the default rules: weights split over model
            from repro_torch.runtime.sharding import in_context, sharding_context

            with sharding_context(self.mesh):
                prefill, decode = in_context(prefill), in_context(decode)

        t0 = time.monotonic()
        if encdec:
            cache = ed_mod.encdec_init_cache(params, cfg, inputs["frames"], SpringContext(),
                                             max_len=prompt_len + gen)
            logits = torch.zeros((batch, cfg.vocab), device=self.device)
            next_tok = tokens[:, 0]
        else:
            logits, cache = prefill(params, tokens, img_embeds=inputs.get("img_embeds"))
            # decode continues past the prompt: extend the cache buffers
            cache = pad_cache(cache, gen)
            next_tok = logits.argmax(-1)
        _sync(self.device)
        t_prefill = time.monotonic() - t0

        tokens_out = []
        t0 = time.monotonic()
        for i in range(gen):
            logits, cache = decode(params, next_tok, cache)
            if spec.serving.greedy:
                next_tok = logits.argmax(-1)
            else:
                next_tok = torch.tensor(
                    [sample_token(logits[b], seed + b, i + 1) for b in range(batch)],
                    dtype=torch.int64, device=self.device)
            tokens_out.append(next_tok)
        _sync(self.device)
        t_decode = time.monotonic() - t0

        out = {
            "generated": torch.stack(tokens_out, dim=1).cpu().numpy().astype(np.int32),
            "prefill_s": t_prefill,
            "decode_s": t_decode,
            "tokens_per_s": batch * gen / t_decode if t_decode else 0.0,
            "finite": bool(torch.isfinite(logits).all()),
            "engine": False,
            "mesh": spec.shape.mesh.label(),
        }
        if sharded:
            from repro_torch.dist.collectives import collective_probe

            out["collective_probe"] = collective_probe(
                spec.sparsity.probe_density, world=spec.shape.mesh.data, device=self.device)
        if tp:
            out["tensor_parallel"] = self._tp_report(params, cache)
        return out

    def _engine(self) -> dict:
        from repro_torch.serving.engine import ServingEngine

        spec, r = self.spec, self.resolved
        batch, prompt_len, gen = (spec.shape.batch, spec.shape.prompt_len,
                                  spec.shape.gen)
        # None means "default to batch" (from_spec applies the same rule to
        # slots; an explicit 0 reaches the engine's own validation)
        queue = spec.serving.queue
        n_requests = batch if queue is None else queue
        seed = spec.seeds.seed

        tp = self._tensor_parallel()
        # under tp the engine keeps this rank's shards of given parameters,
        # or draws its own leaf by leaf
        engine = ServingEngine.from_spec(spec, params=self.params, resolved=r,
                                         prune_ratio=self.prune_ratio, device=self.device,
                                         mesh=self.mesh)
        if spec.serving.restore_path:
            # spring-survive resume: drain a saved snapshot's in-flight work
            # instead of submitting fresh requests
            engine.restore_file(spec.serving.restore_path)
        else:
            cfg = r.config
            prompts = synthetic_prompts(n_requests, batch, prompt_len, cfg.vocab, seed)
            images = (synthetic_images(n_requests, batch, cfg.vlm_prefix_len, cfg.d_model, seed)
                      if cfg.vlm_prefix_len else [None] * n_requests)
            for i, p in enumerate(prompts):
                engine.submit_prompt(p, gen, seed=seed + i, img_embeds=images[i])
        out = engine.run()
        # token lists may be ragged (EOS finishes / typed rejections):
        # stack only the uniform case, keep exact lists otherwise
        tok_lists = [req["tokens"] for req in out["per_request"]]
        out["generated"] = (np.asarray(tok_lists, np.int32)
                            if len({len(t) for t in tok_lists}) == 1 else tok_lists)
        out["engine"] = True
        out["slots"] = engine.n_slots
        out["mode"] = spec.numerics.mode
        if tp:
            out["tensor_parallel"] = dict(
                self._tp_report(engine.params), pool_bytes=engine.pool_bytes(),
                state_bytes=engine.state_bytes(),
                kv_heads=None if engine.heads is None else list(engine.heads.mine))
        return out


def build_mesh(mesh, device="cpu"):
    """The mesh of a ``MeshSpec``: explicit axis extents build a ``(pod,
    data, model)`` mesh over the process group's ranks
    (:func:`repro_torch.dist.mesh.make_explicit_mesh`); a named kind alone
    builds none (None), as the reference's sessions build none for it (its
    named meshes serve the dry run, which has no twin)."""
    if isinstance(mesh, str) or not mesh.explicit:
        return None
    from repro_torch.dist.mesh import make_explicit_mesh

    return make_explicit_mesh(mesh.pod, mesh.data, mesh.model, device=device)


SESSION_TYPES = {
    "train": TrainSession,
    "serve": ServeSession,
    "dryrun": DryrunSession,
}


def session_for(spec: RunSpec, **kw) -> Session:
    """The one dispatch point: a spec's ``run`` field picks its session."""
    return SESSION_TYPES[spec.run](spec, **kw)


# -- legacy kwargs -> spec bridges (the reference's signatures) --------------


def _call_overrides(pairs) -> list:
    return [(path, value, f"call:{path}") for path, value in pairs
            if value is not None]


def train_spec(arch_id: str = "llama3.2-1b", *, reduced: bool = True,
               steps: int = 100, batch: int = 8, seq: int = 128,
               mode: str = "dense", lr: float = 3e-3,
               fixed_point_weights: bool = False,
               kernel_impl: Optional[str] = None,
               backward_sparsity: str = "auto", stash: str = "none",
               ckpt_dir: Optional[str] = None, ckpt_every: int = 100,
               log_every: int = 10, seed: int = 0) -> RunSpec:
    """RunSpec equivalent of the legacy ``train_loop`` keyword surface."""
    return build_spec("train", overrides=_call_overrides([
        ("arch.id", arch_id), ("arch.reduced", reduced),
        ("train.steps", steps), ("shape.batch", batch), ("shape.seq", seq),
        ("numerics.mode", mode), ("optimizer.lr", lr),
        ("numerics.fixed_point_weights", fixed_point_weights),
        ("kernels.policy", kernel_impl),
        ("sparsity.backward", backward_sparsity),
        ("memstash.policy", stash),
        ("train.ckpt_dir", ckpt_dir or ""), ("train.ckpt_every", ckpt_every),
        ("train.log_every", log_every), ("seeds.seed", seed),
    ]))


def serve_spec(arch_id: str = "llama3.2-1b", *, reduced: bool = True,
               batch: int = 4, prompt_len: int = 32, gen: int = 16,
               mode: str = "dense", kernel_impl: Optional[str] = None,
               greedy: bool = True, seed: int = 0,
               slots: Optional[int] = None, queue: Optional[int] = None,
               static: bool = False, pages: bool = False,
               page_tokens: Optional[int] = None,
               num_pages: Optional[int] = None,
               overcommit: Optional[float] = None,
               prefix_cache: Optional[bool] = None,
               snapshot_every: Optional[int] = None,
               snapshot_path: Optional[str] = None,
               restore_path: Optional[str] = None,
               max_queue_depth: Optional[int] = None,
               deadline_ticks: Optional[int] = None,
               deadline_aware: Optional[bool] = None,
               priority_aware: Optional[bool] = None) -> RunSpec:
    """RunSpec equivalent of the legacy ``serve_session`` surface."""
    over = _call_overrides([
        ("arch.id", arch_id), ("arch.reduced", reduced),
        ("shape.batch", batch), ("shape.prompt_len", prompt_len),
        ("shape.gen", gen), ("numerics.mode", mode),
        ("kernels.policy", kernel_impl), ("serving.greedy", greedy),
        ("seeds.seed", seed), ("serving.static", static),
        ("serving.pages", pages),
    ])
    # slots/queue: None means "default to batch" and must stay None in the
    # spec (an explicit 0 must reach the engine's own validation)
    if slots is not None:
        over.append(("serving.slots", slots, "call:serving.slots"))
    if queue is not None:
        over.append(("serving.queue", queue, "call:serving.queue"))
    # paged-pool + spring-survive knobs: None keeps the spec default
    for key, value in (("page_tokens", page_tokens), ("num_pages", num_pages),
                       ("overcommit", overcommit),
                       ("prefix_cache", prefix_cache),
                       ("snapshot_every", snapshot_every),
                       ("snapshot_path", snapshot_path),
                       ("restore_path", restore_path),
                       ("max_queue_depth", max_queue_depth),
                       ("deadline_ticks", deadline_ticks),
                       ("deadline_aware", deadline_aware),
                       ("priority_aware", priority_aware)):
        if value is not None:
            over.append((f"serving.{key}", value, f"call:serving.{key}"))
    return build_spec("serve", overrides=over)


def dryrun_spec(arch_id: str, shape_name: str, mesh_kind: str = "single",
                mode: str = "dense", *, microbatch: Optional[int] = None,
                cost_unrolled: bool = True, seq_parallel: bool = False,
                bf16_logits: bool = False, layout: str = "tp",
                remat_policy: str = "full", cache_int8: bool = False,
                quant_opt: bool = False, variant: str = "baseline",
                kernel_impl: Optional[str] = None,
                backward_sparsity: str = "auto",
                probe_density: float = 0.5) -> RunSpec:
    """RunSpec equivalent of the legacy ``run_cell`` keyword surface
    (``arch.reduced`` stays null)."""
    over = _call_overrides([
        ("arch.id", arch_id),
        ("shape.cell", shape_name), ("shape.mesh", mesh_kind),
        ("numerics.mode", mode),
        ("dryrun.cost_unrolled", cost_unrolled),
        ("shape.seq_parallel", seq_parallel),
        ("arch.bf16_logits", bf16_logits), ("shape.layout", layout),
        ("serving.int8_cache", cache_int8), ("dryrun.quant_opt", quant_opt),
        ("dryrun.variant", variant), ("kernels.policy", kernel_impl),
        ("sparsity.backward", backward_sparsity),
        ("sparsity.probe_density", probe_density),
    ])
    if microbatch is not None:
        over.append(("shape.microbatch", microbatch, "call:shape.microbatch"))
    # legacy quirk preserved: --remat-policy full was a no-op
    if remat_policy != "full":
        over.append(("arch.remat_policy", remat_policy,
                     "call:arch.remat_policy"))
    return build_spec("dryrun", overrides=over)
