"""The training loop (port of ``smmdax/trainer.py``): alternation
scheduling, logging, sample grids, checkpoints, in-loop FID/KID scoring
and the KID-driven learning-rate scheduler.

As in the JAX package: ``start_dsteps`` critic updates for the first
``warmup_iterations`` macro-steps, then ``dsteps``; up to
``steps_per_dispatch`` macro-steps per dispatch, clipped so that no
dispatch crosses an event (logging, samples, checkpoints, scoring, fixed
LR decay, the warm-up switch, the profiler window, the end); a host thread
assembling the next uint8 batches (a pure function of (seed, step)) while
the device runs; preemption by SIGTERM / SIGINT checkpoints and stops.
Scoring and the scheduler decisions are keyed by step, so a resumed run
repeats an uninterrupted one's decisions.

On the card the scoring features never leave it (the extractor runs on
the generated images where they are, and the subset sweeps run there);
on the CPU they are numpy and the float64 arm scores them, as the JAX
package does on the CPU.
"""

from __future__ import annotations

import os
import queue
import signal
import sys
import threading
from typing import Dict, Optional

import numpy as np
import torch

from smmdax_torch.checkpoint import CheckpointManager
from smmdax_torch.configs import Config
from smmdax_torch.data.pipeline import macro_batch_at, make_dataset
from smmdax_torch.eval.features import extract_features, extract_with_probs, get_feature_extractor
from smmdax_torch.eval.scores import (frechet_distance, gaussian_stats, inception_score,
                                      kid_from_features, relative_mmd_test,
                                      relative_similarity_test, use_device_scoring)
from smmdax_torch.train import (TrainState, check_single_device, create_state,
                                dispatch_train_step, resolve_device, sample)
from smmdax_torch.utils import MetricWriter, StepTimer, save_images


def _chunk_seed(seed: int, ci: int) -> int:
    """The generator seed of scoring chunk ``ci``: a fixed function of
    (seed, ci), the counterpart of JAX's ``fold_in(rng, ci)``."""
    return int(np.random.SeedSequence([seed, ci]).generate_state(1, np.uint64)[0])


class Trainer:
    """``Trainer(cfg, device="cuda").train()``.  Raises without a card
    unless ``device="cpu"``; refuses the execution modes not ported yet
    (several ranks, in-program data)."""

    def __init__(self, cfg: Config, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        check_single_device(cfg)
        if (cfg.with_scaling and cfg.scaling_grad_estimator == "exact"
                and cfg.output_size >= 64):
            print("[smmdax_torch] note: scaling_grad_estimator='exact' at "
                  f"output_size={cfg.output_size} runs dof_dim backward passes "
                  "per sigma; consider --scaling_grad_estimator hutchinson",
                  flush=True)
        self.source = make_dataset(cfg)
        self.state = create_state(cfg, seed=cfg.random_seed, device=self.device)
        self.ckpt = CheckpointManager(os.path.join(cfg.checkpoint_dir, cfg.run_name()))
        # whether THIS process resumed: only a resumed run rebuilds the
        # scheduler's best snapshot (a fresh run in a directory holding a
        # dead run's best checkpoint must not adopt it)
        self._resumed = self.ckpt.restore(self.state) is not None
        if self._resumed:
            print(f"[smmdax_torch] resumed from step {self.state.step}")
        self.writer = MetricWriter(cfg.log_dir, cfg.run_name(), also_stdout=cfg.log,
                                   tensorboard=cfg.tensorboard)
        self._step_cache: Dict[tuple, callable] = {}
        self._extractor = None
        # scoring feature sets: numpy on the CPU, tensors on the card
        self._real_feats = None
        self._real_stats: Optional[tuple] = None      # FID (mu, cov) of the real set
        self._best_feats = None
        self._best_kid: float = float("inf")
        self._profiler = None

    # ------------------------------------------------------------------
    def _dsteps_at(self, step: int) -> int:
        if step < self.cfg.warmup_iterations and self.cfg.start_dsteps != self.cfg.dsteps:
            return self.cfg.start_dsteps
        return self.cfg.dsteps

    def _get_step(self, dsteps: int, k: int):
        """The (cached) dispatch of ``k`` macro-steps at ``dsteps`` critic
        updates."""
        key = (dsteps, k)
        fn = self._step_cache.get(key)
        if fn is None:
            fn = dispatch_train_step(self.cfg, dsteps, self.cfg.gsteps,
                                     steps_per_dispatch=k)
            self._step_cache[key] = fn
        return fn

    def _next_boundary(self, step: int) -> int:
        """First step > ``step`` at which the host must observe the state:
        logging, sampling, checkpointing, scoring, fixed LR decay, the
        warm-up switch, the profiler window's edges and the end.
        Dispatches never cross these, so every cadence behaves exactly as
        with steps_per_dispatch=1."""
        cfg = self.cfg
        cands = [cfg.max_iteration]
        if step < cfg.warmup_iterations and cfg.start_dsteps != cfg.dsteps:
            cands.append(cfg.warmup_iterations)
        periodic = [cfg.log_every, cfg.sample_every, cfg.checkpoint_every,
                    cfg.lr_decay_steps]
        if cfg.compute_scores:
            periodic.append(cfg.score_every)
        for every in periodic:
            if every:
                cands.append((step // every + 1) * every)
        if cfg.profile_steps:
            for edge in (cfg.profile_start, cfg.profile_start + cfg.profile_steps):
                if edge > step:
                    cands.append(edge)
        return min(c for c in cands if c > step)

    # ceiling on the float32 image bytes one scoring generation holds at
    # once; features are (n, d) and small
    SCORE_CHUNK_IMAGE_BYTES = 512 * 1024 * 1024

    def _gen_feats(self, state: TrainState, seed: int, n: int, use_ema: bool = True):
        """(features, probs) of ``n`` eval-mode samples of ``state``, with
        latents from a generator seeded ``seed``, generated in chunks of at
        most SCORE_CHUNK_IMAGE_BYTES of images, each dropped once its
        features are taken.  One chunk covering ``n`` is exactly the
        unchunked sample -> extract; chunk ``ci`` of a larger set draws
        from ``_chunk_seed(seed, ci)``."""
        cfg = self.cfg
        fetch = not use_device_scoring(self.device)
        per_img = int(np.prod(cfg.image_shape)) * 4
        chunk = max(cfg.batch_size,
                    (self.SCORE_CHUNK_IMAGE_BYTES // per_img)
                    // cfg.batch_size * cfg.batch_size)
        if chunk >= n:
            imgs = sample(cfg, state, self._generator(seed), n, use_ema=use_ema)
            return extract_with_probs(self._extractor, imgs, fetch=fetch)
        feats, probs = [], []
        for ci, lo in enumerate(range(0, n, chunk)):
            imgs = sample(cfg, state, self._generator(_chunk_seed(seed, ci)),
                          min(chunk, n - lo), use_ema=use_ema)
            f, p = extract_with_probs(self._extractor, imgs, fetch=fetch)
            del imgs
            feats.append(f)
            if p is not None:
                probs.append(p)
        cat = torch.cat if isinstance(feats[0], torch.Tensor) else np.concatenate
        return cat(feats), (cat(probs) if probs else None)

    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(seed)

    def _kid(self, feats) -> float:
        cfg = self.cfg
        n = len(feats)
        return kid_from_features(self._real_feats, feats,
                                 subset_size=min(cfg.score_subset_size, n),
                                 n_subsets=cfg.score_subsets)

    def _score(self, step: int) -> Dict[str, float]:
        """FID/KID of generated samples against the real source, and the
        LR scheduler's decision."""
        cfg = self.cfg
        if self._extractor is None:
            self._extractor = get_feature_extractor(cfg.data_dir, device=self.device)
        # synthetic self-tests cap at 5000 samples; real datasets use the
        # configured count
        n = (min(cfg.no_of_samples, 5000) if cfg.dataset == "synthetic"
             else cfg.no_of_samples)
        seed = cfg.random_seed + step
        fake_feats, fake_probs = self._gen_feats(self.state, seed, n)
        if self._real_feats is None:
            # fixed key: the reference set is the same across resumes
            self._real_feats = extract_features(
                self._extractor, self.source.batch(n, key=2**31 + 1),
                fetch=not use_device_scoring(self.device))
            self._real_stats = None
        if cfg.MMD_lr_scheduler and self._best_feats is None and self._resumed:
            # resumed run: rebuild the best snapshot's features with the
            # scoring seed its step used, and its KID from the meta, so the
            # decisions equal an uninterrupted run's
            best_state = self.ckpt.restore_best(self.state)
            meta = self.ckpt.best_meta()
            if best_state is not None and meta is not None:
                self._best_feats, _ = self._gen_feats(
                    best_state, cfg.random_seed + int(meta["best_step"]), n)
                self._best_kid = float(meta["best_kid"])
            elif best_state is not None:
                # a best snapshot without its meta: re-score it (fixed seed)
                # rather than let the first score replace a better snapshot
                self._best_feats, _ = self._gen_feats(best_state, cfg.random_seed, n)
                self._best_kid = self._kid(self._best_feats)[0]
        if self._real_stats is None:
            self._real_stats = gaussian_stats(self._real_feats)
        fid = frechet_distance(*self._real_stats, *gaussian_stats(fake_feats))
        kid, kid_std = self._kid(fake_feats)
        out = {"fid": fid, "kid": kid, "kid_std": kid_std}
        if fake_probs is not None:
            out["inception_score"], out["inception_score_std"] = inception_score(fake_probs)
        if cfg.ema_decay > 0 and cfg.ema_eval_compare:
            # the live weights scored with the same seed and real set: the
            # EMA's effect without seed noise (evidence only; the scheduler
            # uses the EMA scores)
            live_feats, _ = self._gen_feats(self.state, seed, n, use_ema=False)
            out["fid_live"] = frechet_distance(*self._real_stats,
                                               *gaussian_stats(live_feats))
            out["kid_live"] = self._kid(live_feats)[0]

        if not cfg.MMD_lr_scheduler:
            return out
        if self._best_feats is None or kid < self._best_kid:
            self._promote(fake_feats, kid, step)
            out["lr_decayed"] = 0.0
            return out
        # three-sample test against the best snapshot, with subsets keyed
        # by step
        if cfg.three_sample_test == "pvalue":
            p_val, t_stat = relative_mmd_test(
                self._real_feats, fake_feats, self._best_feats,
                subset_size=min(cfg.scheduler_test_size, n),
                n_subsets=cfg.scheduler_test_subsets, seed=step, combine="fisher")
            out["three_sample_p"] = p_val
            out["three_sample_t"] = t_stat
            improved = p_val < cfg.scheduler_p_threshold
        else:
            win = relative_similarity_test(
                self._real_feats, fake_feats, self._best_feats,
                subset_size=min(cfg.score_subset_size, n),
                n_subsets=cfg.score_subsets, seed=step)
            out["three_sample_win"] = win
            improved = win > 0.5
        if improved:
            # significantly closer than the best snapshot: it becomes the best
            self._promote(fake_feats, kid, step)
            out["lr_decayed"] = 0.0
            return out
        # decay only after scheduler_patience consecutive failed tests; the
        # count rides the state, so a resumed run repeats the decisions
        fails = self.state.sched_fails + 1
        out["sched_fails"] = float(fails)
        if fails < cfg.scheduler_patience:
            self.state.sched_fails = fails
            out["lr_decayed"] = 0.0
            return out
        if cfg.reload_best_on_decay:
            # rewind the model to the best snapshot, keeping the step and
            # the noise stream so the data and schedule go on unchanged
            best_state = self.ckpt.restore_best(self.state)
            if best_state is not None:
                best_state.step = self.state.step
                best_state.generator = self.state.generator
                best_state.lr_d, best_state.lr_g = self.state.lr_d, self.state.lr_g
                self.state = best_state
                out["reloaded_best"] = 1.0
        self._decay_lr()
        self.state.sched_fails = 0
        out["lr_decayed"] = 1.0
        return out

    def _promote(self, feats, kid: float, step: int) -> None:
        """Make the current model the best snapshot (saved before training
        goes on) and reset the failure count."""
        self._best_feats, self._best_kid = feats, kid
        self.ckpt.save_best(self.state, meta={"best_kid": float(kid), "best_step": int(step)})
        self.state.sched_fails = 0

    def _decay_lr(self) -> None:
        # new tensors, not in-place: logged metrics hold the old ones
        self.state.lr_d = self.state.lr_d * self.cfg.decay_rate
        self.state.lr_g = self.state.lr_g * self.cfg.decay_rate

    # ------------------------------------------------------------------
    def _make_batch(self, s: int):
        """(warm-up?, uint8 or float macro-batch) of step ``s``."""
        cfg = self.cfg
        warm = self._dsteps_at(s) == cfg.start_dsteps and cfg.start_dsteps != cfg.dsteps
        per_step = (cfg.start_dsteps if warm else cfg.dsteps) + cfg.gsteps
        if cfg.uint8_transfer and hasattr(self.source, "batch_u8"):
            return warm, macro_batch_at(self.source, s, per_step, cfg.real_batch_size, u8=True)
        batch = macro_batch_at(self.source, s, per_step, cfg.real_batch_size)
        if cfg.uint8_transfer and batch.dtype == np.float32:
            batch = np.round((batch + 1.0) * 127.5).astype(np.uint8)
        return warm, batch

    def train(self) -> TrainState:
        cfg = self.cfg
        timer = StepTimer()
        step = self.state.step
        # preemption: on SIGTERM/SIGINT finish the dispatch in flight,
        # checkpoint and stop; the next run resumes from there
        self._preempted = False
        self._rss_tripped = False

        def _on_term(signum, frame):
            self._preempted = True

        try:
            old_term = signal.signal(signal.SIGTERM, _on_term)
            old_int = signal.signal(signal.SIGINT, _on_term)
        except ValueError:           # not the main thread
            old_term = old_int = None

        # a producer thread assembles the next macro-batches while the
        # device runs; bounded, so a dispatch never waits on it once warm
        q: "queue.Queue" = queue.Queue(maxsize=max(2, 2 * cfg.steps_per_dispatch))
        stop = threading.Event()

        def _producer(start: int):
            s = start
            while s < cfg.max_iteration and not stop.is_set():
                item = self._make_batch(s)
                while not stop.is_set():
                    try:
                        q.put((s, item), timeout=0.5)
                        break
                    except queue.Full:
                        continue
                s += 1

        producer = threading.Thread(target=_producer, args=(step,), daemon=True)
        producer.start()
        try:
            self._train_loop(cfg, timer, step, q)
        finally:
            stop.set()
            producer.join(timeout=5)
            if self._profiler is not None:
                self._stop_profiler()
            if old_term is not None:
                signal.signal(signal.SIGTERM, old_term)
                signal.signal(signal.SIGINT, old_int)
        self.ckpt.save(self.state.step, self.state)
        if self._rss_tripped and cfg.auto_restart:
            # the state is checkpointed: replace the process and resume
            print("[smmdax_torch] rss watchdog: re-exec to reclaim host memory")
            self._reexec()
        return self.state

    def _train_loop(self, cfg: Config, timer: StepTimer, step: int, q) -> None:
        while step < cfg.max_iteration:
            if self._preempted:
                print(f"[smmdax_torch] preemption signal: checkpointing at step {step}")
                break
            # one dispatch = up to steps_per_dispatch macro-steps, never
            # crossing an event boundary
            k_eff = min(cfg.steps_per_dispatch, self._next_boundary(step) - step)
            parts, warm = [], None
            for i in range(k_eff):
                # bounded: a producer killed by a data error fails here
                s, (w, b) = q.get(timeout=600)
                if s != step + i or (warm is not None and warm != w):
                    raise RuntimeError(f"batch of step {s} (warm-up {w}) where "
                                       f"step {step + i} (warm-up {warm}) was due")
                warm = w
                parts.append(b)
            batch = parts[0] if k_eff == 1 else np.stack(parts)
            dsteps = cfg.start_dsteps if warm else cfg.dsteps
            step_fn = self._get_step(dsteps, k_eff)
            if cfg.profile_steps and step == cfg.profile_start:
                self._start_profiler()
            self.state, metrics = step_fn(self.state, batch)
            step += k_eff
            if self._profiler is not None and step == cfg.profile_start + cfg.profile_steps:
                self._stop_profiler()
            if cfg.debug_nans:
                self._check_finite(step, metrics)
            timer.add(k_eff * (dsteps + cfg.gsteps) * cfg.real_batch_size)

            if cfg.lr_decay_steps and step % cfg.lr_decay_steps == 0:
                self._decay_lr()

            if (cfg.log_every and step % cfg.log_every == 0) or step == cfg.max_iteration:
                m = {k: float(v) for k, v in metrics.items()}
                m["images_per_sec"] = timer.rate()
                self.writer.write(step, m)
                timer.reset()
                if cfg.rss_limit_gb and self._rss_gb() > cfg.rss_limit_gb:
                    # trip the graceful preemption path before the OOM
                    # killer ends the process the hard way
                    print(f"[smmdax_torch] rss watchdog: {self._rss_gb():.1f} GB"
                          f" > limit {cfg.rss_limit_gb} GB")
                    self._rss_tripped = True
                    self._preempted = True

            if cfg.sample_every and step % cfg.sample_every == 0:
                self._save_samples(step)

            if cfg.checkpoint_every and step % cfg.checkpoint_every == 0:
                self.ckpt.save(step, self.state)

            if cfg.compute_scores and cfg.score_every and step % cfg.score_every == 0:
                self.writer.write(step, self._score(step))

    @staticmethod
    def _check_finite(step: int, metrics: Dict[str, torch.Tensor]) -> None:
        """``debug_nans``: raise at the first dispatch whose metrics are not
        finite (the eager counterpart of ``jax_debug_nans``, checked per
        dispatch rather than per operation)."""
        bad = {k: float(v) for k, v in metrics.items() if not bool(torch.isfinite(v).all())}
        if bad:
            raise FloatingPointError(f"non-finite metrics after step {step}: {bad}")

    def _start_profiler(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._profiler = profile(activities=acts)
        self._profiler.__enter__()

    def _stop_profiler(self) -> None:
        """Close the profiler window and write its Chrome trace under
        log_dir/profile/<run_name>."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof, self._profiler = self._profiler, None
        prof.__exit__(None, None, None)
        out = os.path.join(self.cfg.log_dir, "profile", self.cfg.run_name())
        os.makedirs(out, exist_ok=True)
        prof.export_chrome_trace(os.path.join(out, f"trace_{self.cfg.profile_start}.json"))

    @staticmethod
    def _rss_gb() -> float:
        """Current process resident set, in GB (Linux)."""
        try:
            with open("/proc/self/status") as f:
                for line in f:
                    if line.startswith("VmRSS"):
                        return int(line.split()[1]) / 2**20
        except OSError:
            pass
        return 0.0

    def _reexec(self) -> None:
        """Replace this process with a fresh copy of itself (same argv); it
        resumes from the checkpoint just written."""
        os.execv(sys.executable, [sys.executable] + sys.argv)

    def _save_samples(self, step: int) -> None:
        out_dir = os.path.join(self.cfg.sample_dir, self.cfg.run_name())
        imgs = sample(self.cfg, self.state, self._generator(step), 64)
        save_images(imgs.cpu().numpy(), os.path.join(out_dir, f"sample_{step:07d}.png"))


def train(cfg: Config, device="cuda") -> TrainState:
    return Trainer(cfg, device=device).train()
