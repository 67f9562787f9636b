"""Training orchestration: the end-to-end TSVD topic-model pipeline.

Mirrors ISLETrainer (reference include/trainer.h:35-266,
src/trainer.cpp:425-654 `train()`) with the three ingest modes
(file / iterative feed / preprocessed artifact) and the same stage order:

  ingest -> normalize -> zeta thresholds -> B = threshold+sqrt-scale
  [-> importance-sample docs] -> truncated SVD of B B^T -> k-means++ on
  U^T B -> Lloyd's (projected) -> lift centers -> Lloyd's (full space) ->
  remap clusters to original docs -> r-th-highest stats -> catchwords ->
  topic matrix [-> edge topics].

Beyond the reference, every stage checkpoints its outputs to the run
directory (the reference restarts only from final artifacts; SURVEY.md
§5.4), and all randomness is seeded.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from . import io_text
from .bmatrix import threshold_and_copy
from .catchwords import catchword_topic_map, find_catchwords, rth_highest
from .config import TrainConfig
from .corpus import Corpus, EntryFeeder, read_vocab_file
from .kmeans import (
    kmeans_init_on_projected,
    run_lloyds_full,
    run_lloyds_projected,
)
from .linalg import block_ks
from .matops import mat_b_y, mat_bt_x, mat_gram_x, mat_spmm_flops
from .obs import Logger, OpCounter, Timer
from .sparse import DocSparse, frobenius_sq
from .thresholds import compute_thresholds_jax
from .topic_model import construct_edge_topics_v2, construct_topic_model

HI = jax.lax.Precision.HIGHEST


def solve_gram_eigens(
    op,
    V: int,
    k: int,
    op_data,
    cfg,
    key,
    timer=None,
    logger=None,
    start_block=None,
):
    """Shared truncated-eigensolver dispatch for B·Bᵀ, honoring
    `hyper.eigensolver` identically across the in-core, sharded, and
    streamed training modes (no silent fallback to the default solver;
    the reference selects its solver once, compile-time, for every path —
    hyperparams.h:31). The dense oracle works on every layout —
    matops.mat_to_dense gathers sharded operands to host, where the
    float64 eigh runs anyway.

    Returns (evalues np.float32[k], U (V, k) jax, stats) where stats is
    None for the dense oracle and (res, op_width) for iterative
    solvers."""
    hp = cfg.hyper
    eigensolver = hp.eigensolver
    if eigensolver not in ("dense", "block_ks", "lanczos"):
        raise ValueError(f"unknown eigensolver {eigensolver!r}")
    if eigensolver != "dense" and 2 * k + 2 >= V:
        if logger:
            logger.warning(
                f"k={k} too close to vocab={V} for a Krylov solver; "
                "falling back to the dense eigensolver"
            )
        eigensolver = "dense"
    if eigensolver == "dense":
        from .linalg import dense_topk_eigh
        from .matops import mat_to_dense

        Bd = mat_to_dense(op_data).astype(np.float64)
        w_np, U_np = dense_topk_eigh(Bd @ Bd.T, k)
        return w_np.astype(np.float32), jnp.asarray(U_np, jnp.float32), None
    from .linalg import block_ks, block_ks_device, lanczos_device

    if eigensolver == "lanczos":
        solver, kwargs, op_width = lanczos_device, {}, 1
        if start_block is not None:
            # width-1 recurrence: seed from the dominant checkpointed
            # eigenvector (columns of U are eigenvalue-descending)
            kwargs["start_vector"] = start_block[:, 0]
    else:
        solver = block_ks_device if cfg.device.device_loop_solver else block_ks
        kwargs = dict(blk=hp.block_ks_block_size)
        if start_block is not None:
            kwargs["start_block"] = start_block
        op_width = hp.block_ks_block_size
    res = solver(
        op,
        V,
        k,
        op_data=op_data,
        tol=hp.block_ks_tolerance,
        max_restarts=hp.block_ks_max_iters,
        key=key,
        timer=timer,
        **kwargs,
    )
    if res.nconv < k:
        if hp.block_ks_strict:
            # The reference asserts on non-convergence
            # (src/sparseMatrix.cpp:1207 `assert(nconv == num_topics)`).
            raise RuntimeError(
                f"{eigensolver} converged only {res.nconv}/{k} eigenpairs "
                f"within {hp.block_ks_max_iters} restarts "
                f"(block_ks_strict=True; evals head "
                f"{np.asarray(res.evals[:4]).tolist()})"
            )
        if logger:
            logger.warning(
                f"{eigensolver} converged only {res.nconv}/{k} eigenpairs"
            )
    return res.evals, res.evecs, (res, op_width)


class Trainer:
    def __init__(
        self,
        config: TrainConfig,
        output_dir: str = ".",
        vocab_file: Optional[str] = None,
        quiet: bool = False,
    ):
        self.config = config
        self.output_dir = output_dir
        self.run_dir = os.path.join(output_dir, config.log_dir_name())
        os.makedirs(self.run_dir, exist_ok=True)
        self.logger = Logger(self.run_dir, quiet=quiet)
        self.timer = Timer(self.logger)
        self.op_counter = OpCounter("gram SpMM")
        self.vocab_file = vocab_file
        self.corpus: Optional[Corpus] = None
        self.vocab_words: List[str] = []
        self._feeder: Optional[EntryFeeder] = None
        self.is_training_complete = False

        # Results
        self.model: Optional[np.ndarray] = None  # (vocab, k)
        self.edge_model: Optional[np.ndarray] = None
        self.edge_pairs: Optional[np.ndarray] = None
        self.evalues: Optional[np.ndarray] = None
        # eigenpairs the iterative solver converged (its own criterion)
        self.eigen_nconv: Optional[int] = None
        self.centers: Optional[np.ndarray] = None  # (k, vocab)
        self.cluster_of_doc: Optional[np.ndarray] = None
        self.catchword_thresholds: Optional[np.ndarray] = None  # (k, vocab)
        self.catchwords: Optional[List[np.ndarray]] = None
        self.top_pairs = None
        self.original_cols: Optional[np.ndarray] = None
        self._report_A: Optional[DocSparse] = None

    # ------------------------------------------------------------------
    # Ingest (the three data_ingest modes, include/trainer.h:92-95)
    # ------------------------------------------------------------------

    def load_data_from_file(self, tdf_path: str) -> None:
        c = self.config
        self.corpus = Corpus.from_tdf_file(
            tdf_path,
            vocab_size=c.vocab_size,
            num_docs=c.num_docs,
            tf_idf=c.tf_idf,
            int_normalized=c.hyper.use_int_normalized_counts,
        )
        self._post_ingest()
        self.timer.next("load + finalize data")

    def feed_data(self, doc: int, words, counts) -> None:
        if self._feeder is None:
            self._feeder = EntryFeeder()
        self._feeder.feed(doc, words, counts)

    def finalize_data(self) -> None:
        assert self._feeder is not None, "feed_data first"
        c = self.config
        self.corpus = self._feeder.finalize(
            vocab_size=c.vocab_size, num_docs=c.num_docs, tf_idf=c.tf_idf,
            int_normalized=c.hyper.use_int_normalized_counts,
        )
        self._feeder = None
        self._post_ingest()
        self.timer.next("finalize data")

    def load_preprocessed(self, prefix: str) -> None:
        """Binary sidecar artifacts (src/trainer.cpp:296-362; see
        preprocessed.py for the format)."""
        from .preprocessed import load_preprocessed

        self.corpus = load_preprocessed(prefix)
        self._post_ingest()
        self.timer.next("load preprocessed data")

    def _device_A(self) -> DocSparse:
        """Cached device corpus for the post-train reporting stages.
        Each DocSparse.from_corpus re-encodes and re-uploads the full
        corpus; output_doc_topic,
        output_avg_topic_coherence, and compute_input_svd share one
        upload. Populated lazily so the TRAINING HBM profile is
        unchanged (training releases its own A after B is built)."""
        if self._report_A is None:
            self._report_A = DocSparse.from_corpus(
                self.corpus, chunk=self.config.device.spmm_chunk
            )
        return self._report_A

    def _warm_start_block(self, V: int):
        """Restart-warm eigen (device.eigen_warm_start): the previous run's
        checkpointed U seeds the Krylov start block when its shape still
        matches. Returns None (cold start) otherwise."""
        if not self.config.device.eigen_warm_start:
            return None
        path = os.path.join(self.run_dir, "ckpt_svd.npz")
        try:
            with np.load(path) as z:
                U = z["U"]
        except (OSError, KeyError):
            return None
        if U.shape[0] != V:
            self.logger.warning(
                f"eigen_warm_start: checkpointed U has vocab {U.shape[0]} "
                f"!= {V}; cold-starting"
            )
            return None
        self.logger.info(
            f"eigen_warm_start: seeding Krylov block from checkpointed U "
            f"{U.shape}"
        )
        return jnp.asarray(U, jnp.float32)

    def _post_ingest(self) -> None:
        assert self.corpus is not None
        cfg = self.config
        object.__setattr__(cfg, "vocab_size", self.corpus.vocab_size)
        object.__setattr__(cfg, "num_docs", self.corpus.num_docs)
        self.vocab_words = read_vocab_file(
            self.vocab_file or "", self.corpus.vocab_size
        )
        self.logger.info(
            f"#docs: {self.corpus.num_docs}  #vocab: {self.corpus.vocab_size}  "
            f"nnz: {self.corpus.nnz}  nz_docs: {self.corpus.nz_docs}  "
            f"avg_doc_sz: {self.corpus.avg_doc_sz}"
        )

    # ------------------------------------------------------------------
    # Training
    # ------------------------------------------------------------------

    def train(self, resume: bool = False) -> None:
        """Run the pipeline; with resume=True, completed stages restore
        from the run directory's checkpoints (mid-run restartability the
        reference lacks — it restarts only from final artifacts,
        SURVEY.md §5.4)."""
        assert self.corpus is not None, "load data first"
        cfg = self.config
        if cfg.device.profile_dir:
            # On-demand XLA trace around the whole pipeline (§5.1).
            jax.profiler.start_trace(cfg.device.profile_dir)
            try:
                return self._train_inner(resume)
            finally:
                jax.profiler.stop_trace()
        return self._train_inner(resume)

    def _train_inner(self, resume: bool = False) -> None:
        cfg = self.config
        if cfg.device.mesh_devices() > 1:
            return self._train_sharded(resume=resume)
        hp = cfg.hyper
        k = cfg.num_topics
        V = self.corpus.vocab_size
        D = self.corpus.num_docs
        key = jax.random.PRNGKey(cfg.seed)

        ck = self._load_checkpoints() if resume else {}
        if self._restore_model_checkpoint(ck):
            return
        resume_kmeans = "kmeans" in ck
        resume_svd = "svd" in ck

        # Rough in-core device footprint: the dual-sorted A (6 arrays) +
        # the hybrid head budget + (D, k)-class working sets. Corpora past
        # this belong in streaming.StreamedTrainer (out-of-core).
        est = 6 * 4 * self.corpus.nnz + cfg.device.dense_head_bytes \
            + 8 * 4 * D * k
        budget = cfg.device.memory_budget()
        if budget is not None and est > budget:
            self.logger.warning(
                f"estimated device footprint ~{est / 2**30:.1f} GiB may "
                "exceed device memory; consider streaming.StreamedTrainer "
                "(out-of-core) for this corpus"
            )

        A = DocSparse.from_corpus(self.corpus, chunk=cfg.device.spmm_chunk)
        self.timer.next("upload A to device")

        # 1. thresholds
        if resume_svd:
            zetas = jnp.asarray(ck["svd"]["zetas"])
            self.original_cols = ck["svd"]["original_cols"]
            self.logger.info("resumed thresholds from 'svd' checkpoint")
        else:
            zetas, new_nnz = compute_thresholds_jax(
                A.d_word,
                A.d_val,
                V,
                self.corpus.avg_doc_sz,
                self.corpus.nz_docs,
                k,
                hp,
            )
            self.logger.info(f"Entries above threshold: {int(new_nnz)}")
            self.timer.next("computing thresholds")

        if resume_kmeans:
            # everything after k-means only needs A + cluster memberships
            self.centers = ck["kmeans"]["centers"]
            cluster_of_doc = ck["kmeans"]["cluster_of_doc"]
            self.cluster_of_doc = cluster_of_doc
            if resume_svd:
                self.evalues = ck["svd"]["evalues"]
            sizes = np.bincount(
                cluster_of_doc[cluster_of_doc >= 0], minlength=k
            ).astype(np.int32)
            self.logger.info("resumed clustering from 'kmeans' checkpoint")
            self._finish_train(A, cluster_of_doc, sizes, k, D, hp, cfg)
            return

        # 2-3. B construction (+ sampling), directly in the optimized
        # dense-head/sparse-tail layout when enabled. B's values are all
        # sqrt(zeta_w) per row (src/sparseMatrix.cpp:1349), so the
        # factored layout applies: bf16 binary head (2 bytes/cell) +
        # valueless tail; the fused builder skips the intermediate B COO.
        key, sub = jax.random.split(key)
        sample = cfg.sample_rate if cfg.sample_docs else None
        from .hybrid import max_head_rows

        use_hybrid = cfg.device.dense_head_bytes > 0 and (
            cfg.device.break_head_cap or max_head_rows(D) >= 8
        )
        if cfg.device.dense_head_bytes > 0 and not use_hybrid:
            self.logger.warning(
                f"num_docs={D} exceeds the int32 flat-scatter head "
                "capacity; falling back to the COO layout"
            )
        if use_hybrid:
            from .hybrid import hybrid_from_thresholds

            B, original_cols, frob_sq = hybrid_from_thresholds(
                A,
                zetas,
                cfg.device.dense_head_bytes,
                chunk=cfg.device.spmm_chunk,
                sample_rate=sample,
                key=sub,
                break_head_cap=cfg.device.break_head_cap,
            )
            self.original_cols = original_cols
            self.logger.info(
                f"Columns remaining after thresholding: {B.num_docs}  "
                f"nnz(B): {B.nnz}  Frob(B): {float(np.sqrt(frob_sq)):.4f}"
            )
            self.logger.diag(
                f"hybrid layout: {B.num_head} dense head rows cover "
                f"{B.head_nnz / max(B.nnz, 1):.0%} of nnz"
            )
            self.timer.next("creating thresholded matrix (fused hybrid)")
        else:
            B, original_cols = threshold_and_copy(
                A, zetas, sample_rate=sample, key=sub,
                chunk=cfg.device.spmm_chunk,
            )
            self.original_cols = original_cols
            self.logger.info(
                f"Columns remaining after thresholding: {B.num_docs}  "
                f"nnz(B): {B.nnz}  "
                f"Frob(B): {float(jnp.sqrt(frobenius_sq(B))):.4f}"
            )
            self.timer.next("creating thresholded and scaled matrix")

        if B.nnz == 0 or B.num_docs == 0:
            raise ValueError(
                "thresholding dropped every entry (nnz(B)=0): the corpus "
                "is too sparse for these hyperparameters — check the "
                "few_samples_threshold_drop / bad_threshold_drop flags "
                "and eps2/eps3/w0_c"
            )

        # 4-5. truncated SVD of B B^T
        key, sub = jax.random.split(key)
        if resume_svd:
            self.evalues = ck["svd"]["evalues"]
            U = jnp.asarray(ck["svd"]["U"])
            self.logger.info("resumed eigenvectors from 'svd' checkpoint")
        else:
            self.evalues, U, stats = solve_gram_eigens(
                lambda B_, X: mat_gram_x(B_, X, cfg.device.spmm_chunk),
                V,
                k,
                B,
                cfg,
                sub,
                timer=self.timer,
                logger=self.logger,
                start_block=self._warm_start_block(V),
            )
            if stats is not None:
                res, op_width = stats
                self.eigen_nconv = res.nconv
                self.op_counter.add(
                    res.op_seconds,
                    mat_spmm_flops(B, op_width) * res.op_calls,
                    res.op_calls,
                )
                self.logger.info(self.op_counter.summary())
        self._print_eigen_data(self.evalues, k)
        self.timer.next("eigen solve (B B^T)")
        if not resume_svd:
            self._checkpoint("svd", U=np.asarray(U), evalues=self.evalues,
                             zetas=np.asarray(zetas),
                             original_cols=original_cols)

        # 6. projected matrix P = U^T B (k x D_B). Materialized by
        # default (P is tiny); use_explicit_projected_matrix=
        # False recomputes it blockwise — the reference's built-in A/B
        # cross-check of this stage (src/trainer.cpp:522-531).
        if hp.use_explicit_projected_matrix:
            P = mat_bt_x(B, U, cfg.device.spmm_chunk).T
        else:
            from .matops import mat_bt_x_blockwise

            P = mat_bt_x_blockwise(B, U, doc_block=hp.doc_block_size).T
        self.timer.next("project docs")

        # 7. k-means++ seeding + Lloyd's in the projected space
        key, sub = jax.random.split(key)
        if not hp.enable_kmeans_on_lowd:
            # seeds are needed to copy B columns directly
            # (hyperparams.h:56-58 assertion)
            assert hp.kmeans_init_method in ("kmeanspp", "kmeansmcmc")
        seeds, centers_lowd, init_residual = kmeans_init_on_projected(
            P, k, hp.kmeans_init_reps, sub,
            method=hp.kmeans_init_method, timer=self.timer,
            mcmc_sample_size=hp.kmeansmcmc_sample_size,
        )
        self.logger.info(f"Best k-means init residual: {init_residual:.4f}")
        self.timer.next("k-means seeds initialization")

        if hp.enable_kmeans_on_lowd:
            centers_lowd, _ = run_lloyds_projected(
                P, centers_lowd, hp.max_kmeans_lowd_reps, timer=self.timer
            )
            centers_full = jnp.matmul(centers_lowd, U.T, precision=HI)
            self.timer.next("converging Lloyds k-means on B_k")
        else:
            onehot = jax.nn.one_hot(seeds, B.num_docs, dtype=jnp.float32)
            centers_full = mat_b_y(B, onehot.T, cfg.device.spmm_chunk).T

        # 8. Lloyd's on B in the full vocab space
        if hp.kmeans_algo_for_sparse == "elkans":
            from .elkans import run_elkans

            centers_full, assign = run_elkans(
                B, centers_full, hp.max_kmeans_reps, timer=self.timer,
                chunk=cfg.device.spmm_chunk,
            )
        else:
            centers_full, assign = run_lloyds_full(
                B, centers_full, hp.max_kmeans_reps, timer=self.timer,
                chunk=cfg.device.spmm_chunk,
            )
        self.centers = np.asarray(centers_full)
        self.timer.next("k-means on B")

        # 9. remap cluster membership to original doc ids
        assign_h = np.asarray(assign)
        cluster_of_doc = np.full(D, -1, np.int32)
        cluster_of_doc[original_cols] = assign_h
        self.cluster_of_doc = cluster_of_doc
        sizes = np.bincount(assign_h, minlength=k).astype(np.int32)
        self._checkpoint("kmeans", centers=self.centers,
                         cluster_of_doc=cluster_of_doc)

        self._finish_train(A, cluster_of_doc, sizes, k, D, hp, cfg)

    def _finish_train(self, A, cluster_of_doc, sizes, k, D, hp, cfg) -> None:
        """Stages 10-12: catchword statistics, catchwords, topic matrix."""
        # 10. r-th highest element per (word, topic)
        r = hp.catchword_rank(
            D, k, cfg.sample_rate if cfg.sample_docs else None
        )
        if r < 1:
            self.logger.warning(
                f"catchword rank r={r} < 1 (tiny corpus); clamping to 1"
            )
            r = 1
        thr = rth_highest(
            A, jnp.asarray(cluster_of_doc), jnp.asarray(sizes), k, r
        )
        self.catchword_thresholds = np.asarray(thr)
        self.timer.next("collecting word freqs in clusters")

        # 11. catchwords
        is_cw = find_catchwords(thr, hp.rho)
        is_cw_h = np.asarray(is_cw)
        cwt = catchword_topic_map(is_cw_h)
        self.catchwords = [np.flatnonzero(is_cw_h[t]) for t in range(k)]
        self.timer.next("finding catchwords for clusters")

        # 12. topic model (+ top-2 pairs for edge topics)
        want_pairs = cfg.compute_edge_topics
        model, pairs = construct_topic_model(
            A,
            jnp.asarray(cwt),
            jnp.asarray(cluster_of_doc),
            k,
            hp.model_rank_threshold(D, k),
            want_top_pairs=want_pairs,
            chunk=cfg.device.spmm_chunk,
        )
        self.model = np.asarray(model)
        extra = {}
        if pairs is not None:
            self.top_pairs = tuple(np.asarray(x) for x in pairs)
            extra = dict(t1=self.top_pairs[0], t2=self.top_pairs[1],
                         valid=self.top_pairs[2])
        self.timer.next("constructing topic vectors")
        self._checkpoint(
            "model",
            model=self.model,
            is_cw=is_cw_h,
            catchword_thresholds=self.catchword_thresholds,
            **extra,
        )
        self.is_training_complete = True

    # ------------------------------------------------------------------
    # Mesh-orchestrated training (multi-chip; DeviceConfig.mesh_shape)
    # ------------------------------------------------------------------

    def _train_sharded(self, resume: bool = False) -> None:
        """The same pipeline with every SpMM-heavy stage sharded over a
        1-D device mesh on the document axis (word axis for the ζ/r-th
        stages), per SURVEY.md §5.7-5.8:

          - ζ thresholds + r-th-highest stats: word-sharded, zero comm
            (the mesh form of the reference's word-major CSR chunking,
            src/trainer.cpp:437-469, 592-635);
          - B construction: per-shard compaction with local doc renumber;
          - eigensolver operator B(BᵀX): psum'd over the mesh
            (include/matUtils.h:336-365 on the mesh);
          - full-space Lloyd's: local assignment, psum'd center update
            (src/sparseMatrix.cpp:1631-1646 on the mesh);
          - topic model: doc-sharded mass + psum'd model SpMM.

        k- and vocab-dimension state (U, centers, Model, the projected
        matrix P) is replicated — tiny next to the nnz payload. Results
        match the single-device path to float tolerance; see
        tests/test_sharded_trainer.py."""
        from .sharding import (
            compact_doc_rows,
            make_mesh,
            pad_doc_rows,
            shard_by_word,
            shard_doc_sparse,
            sharded_b_y,
            sharded_bt_x,
            sharded_gram_x,
            sharded_run_lloyds_full,
            sharded_spmm_flops,
            sharded_threshold_and_copy,
            sharded_thresholds,
        )

        cfg = self.config
        hp = cfg.hyper
        k = cfg.num_topics
        V = self.corpus.vocab_size
        D = self.corpus.num_docs
        n_dev = cfg.device.mesh_devices()
        if len(jax.devices()) < n_dev:
            raise RuntimeError(
                f"mesh_shape={cfg.device.mesh_shape} needs {n_dev} devices, "
                f"have {len(jax.devices())}"
            )
        mesh = make_mesh(n_dev)
        key = jax.random.PRNGKey(cfg.seed)
        self.logger.info(f"sharded training on {n_dev}-device mesh")

        ck = self._load_checkpoints() if resume else {}
        if self._restore_model_checkpoint(ck):
            return
        resume_kmeans = "kmeans" in ck
        resume_svd = "svd" in ck

        doc_ids = self.corpus.doc_ids()
        ssp_A = shard_doc_sparse(
            self.corpus.rows, doc_ids, self.corpus.vals, V, D, mesh
        )
        ws_A = shard_by_word(
            self.corpus.rows, doc_ids, self.corpus.vals, V, D, mesh
        )
        self.timer.next("upload A to device (sharded)")

        # 1. thresholds (word-sharded)
        if resume_svd:
            zetas = ck["svd"]["zetas"]
            self.original_cols = ck["svd"]["original_cols"]
            self.logger.info("resumed thresholds from 'svd' checkpoint")
        else:
            zetas, new_nnz = sharded_thresholds(
                ws_A, self.corpus.avg_doc_sz, self.corpus.nz_docs, k, hp, mesh
            )
            self.logger.info(f"Entries above threshold: {int(new_nnz)}")
            self.timer.next("computing thresholds")

        if resume_kmeans:
            self.centers = ck["kmeans"]["centers"]
            cluster_of_doc = ck["kmeans"]["cluster_of_doc"]
            self.cluster_of_doc = cluster_of_doc
            if resume_svd:
                self.evalues = ck["svd"]["evalues"]
            sizes = np.bincount(
                cluster_of_doc[cluster_of_doc >= 0], minlength=k
            ).astype(np.int32)
            self.logger.info("resumed clustering from 'kmeans' checkpoint")
            self._finish_train_sharded(
                ssp_A, ws_A, cluster_of_doc, sizes, k, D, hp, cfg, mesh
            )
            return

        # 2-3. B construction (+ sampling), doc-sharded
        key, sub = jax.random.split(key)
        B, original_cols = sharded_threshold_and_copy(
            ssp_A,
            zetas,
            mesh,
            sample_rate=cfg.sample_rate if cfg.sample_docs else None,
            key=sub,
        )
        self.original_cols = original_cols
        self.logger.info(
            f"Columns remaining after thresholding: {B.num_docs}  "
            f"nnz(B): {B.nnz}  per-shard docs: {B.valid_docs}"
        )
        self.timer.next("creating thresholded and scaled matrix (sharded)")

        # Factored hybrid layout per shard (global head selection; the
        # optimized SpMM engine for the eigensolver/projection; see
        # sharding.shard_hybrid). B's values are sqrt(zeta) per row.
        B_op = B
        op_gram = lambda B_, X: sharded_gram_x(B_, X, mesh)
        op_bt_x = lambda B_, U_: sharded_bt_x(B_, U_, mesh)
        if cfg.device.dense_head_bytes > 0 and B.num_docs > 0:
            from .sharding import (
                shard_hybrid,
                sharded_h_bt_x,
                sharded_h_gram_x,
            )

            from .hybrid import row_scale_from_zetas

            B_op = shard_hybrid(
                B, row_scale_from_zetas(zetas), mesh,
                cfg.device.dense_head_bytes
            )
            op_gram = lambda B_, X: sharded_h_gram_x(B_, X, mesh)
            op_bt_x = lambda B_, U_: sharded_h_bt_x(B_, U_, mesh)
            self.logger.diag(
                f"sharded hybrid layout: {B_op.num_head} global head rows"
            )
            self.timer.next("hybrid layout (sharded)")

        # 4-5. truncated SVD of B B^T: psum'd Gram operator on the mesh
        key, sub = jax.random.split(key)
        if resume_svd:
            self.evalues = ck["svd"]["evalues"]
            U = jnp.asarray(ck["svd"]["U"])
            self.logger.info("resumed eigenvectors from 'svd' checkpoint")
        else:
            self.evalues, U, stats = solve_gram_eigens(
                op_gram,
                V,
                k,
                B_op,
                cfg,
                sub,
                timer=self.timer,
                logger=self.logger,
                start_block=self._warm_start_block(V),
            )
            if stats is not None:
                res, op_width = stats
                self.op_counter.add(
                    res.op_seconds,
                    sharded_spmm_flops(B, op_width) * res.op_calls,
                    res.op_calls,
                )
                self.logger.info(self.op_counter.summary())
            self._checkpoint(
                "svd", U=np.asarray(U), evalues=self.evalues,
                zetas=np.asarray(zetas), original_cols=original_cols,
            )
        self._print_eigen_data(self.evalues, k)
        self.timer.next("eigen solve (B B^T, sharded)")

        # 6. projected docs P = U^T B (replicated k x nzB — tiny)
        P = compact_doc_rows(op_bt_x(B_op, U), B).T
        self.timer.next("project docs")

        # 7. seeding + projected Lloyd's (replicated dense matmul work)
        key, sub = jax.random.split(key)
        if not hp.enable_kmeans_on_lowd:
            assert hp.kmeans_init_method in ("kmeanspp", "kmeansmcmc")
        seeds, centers_lowd, init_residual = kmeans_init_on_projected(
            P, k, hp.kmeans_init_reps, sub,
            method=hp.kmeans_init_method, timer=self.timer,
            mcmc_sample_size=hp.kmeansmcmc_sample_size,
        )
        self.logger.info(f"Best k-means init residual: {init_residual:.4f}")
        self.timer.next("k-means seeds initialization")

        if hp.enable_kmeans_on_lowd:
            centers_lowd, _ = run_lloyds_projected(
                P, centers_lowd, hp.max_kmeans_lowd_reps, timer=self.timer
            )
            centers_full = jnp.matmul(centers_lowd, U.T, precision=HI)
            self.timer.next("converging Lloyds k-means on B_k")
        else:
            Wseed = jax.nn.one_hot(seeds, B.num_docs, dtype=jnp.float32).T
            centers_full = sharded_b_y(
                B, pad_doc_rows(Wseed, B, mesh), mesh
            ).T

        # 8. k-means on B in the full vocab space (sharded); Elkan's
        # mini-COO buckets are the cross-shard max per rep (see
        # elkans_sharded.py)
        if hp.kmeans_algo_for_sparse == "elkans":
            from .elkans_sharded import sharded_run_elkans

            centers_full, assign_h = sharded_run_elkans(
                B_op, centers_full, hp.max_kmeans_reps, mesh,
                timer=self.timer,
            )
        else:
            centers_full, assign_h = sharded_run_lloyds_full(
                B_op, centers_full, hp.max_kmeans_reps, mesh,
                timer=self.timer,
            )
        self.centers = np.asarray(centers_full)
        self.timer.next("k-means on B (sharded)")

        # 9. remap cluster membership to original doc ids
        cluster_of_doc = np.full(D, -1, np.int32)
        cluster_of_doc[original_cols] = assign_h
        self.cluster_of_doc = cluster_of_doc
        sizes = np.bincount(assign_h, minlength=k).astype(np.int32)
        self._checkpoint("kmeans", centers=self.centers,
                         cluster_of_doc=cluster_of_doc)

        self._finish_train_sharded(
            ssp_A, ws_A, cluster_of_doc, sizes, k, D, hp, cfg, mesh
        )

    def _finish_train_sharded(
        self, ssp_A, ws_A, cluster_of_doc, sizes, k, D, hp, cfg, mesh
    ) -> None:
        """Stages 10-12 on the mesh: word-sharded catchword stats,
        doc-sharded topic mass, psum'd model SpMM."""
        from .sharding import (
            compact_doc_rows,
            pad_doc_rows,
            sharded_b_y,
            sharded_doc_topic_mass,
            sharded_rth_highest,
        )
        from .topic_model import (
            _contribution_weights,
            model_thresholds,
            top_two_topics,
        )

        r = hp.catchword_rank(
            D, k, cfg.sample_rate if cfg.sample_docs else None
        )
        if r < 1:
            self.logger.warning(
                f"catchword rank r={r} < 1 (tiny corpus); clamping to 1"
            )
            r = 1
        thr = sharded_rth_highest(ws_A, cluster_of_doc, sizes, k, r, mesh)
        self.catchword_thresholds = np.asarray(thr)
        self.timer.next("collecting word freqs in clusters (sharded)")

        is_cw = find_catchwords(jnp.asarray(thr), hp.rho)
        is_cw_h = np.asarray(is_cw)
        cwt = catchword_topic_map(is_cw_h)
        self.catchwords = [np.flatnonzero(is_cw_h[t]) for t in range(k)]
        self.timer.next("finding catchwords for clusters")

        has_cw = jnp.asarray(is_cw_h.any(axis=1))
        mass = compact_doc_rows(
            sharded_doc_topic_mass(ssp_A, jnp.asarray(cwt), k, mesh), ssp_A
        )
        thr_m = model_thresholds(mass, has_cw, hp.model_rank_threshold(D, k))
        extra = {}
        if cfg.compute_edge_topics:
            t1, t2, valid = top_two_topics(mass)
            self.top_pairs = tuple(
                np.asarray(x) for x in (t1, t2, valid)
            )
            extra = dict(t1=self.top_pairs[0], t2=self.top_pairs[1],
                         valid=self.top_pairs[2])
        W = _contribution_weights(mass, thr_m, jnp.asarray(cluster_of_doc))
        model = sharded_b_y(ssp_A, pad_doc_rows(W, ssp_A, mesh), mesh)
        sums = jnp.sum(model, axis=0)
        model = jnp.where(sums[None, :] != 0.0, model / sums[None, :], model)
        self.model = np.asarray(model)
        self.timer.next("constructing topic vectors (sharded)")
        self._checkpoint(
            "model",
            model=self.model,
            is_cw=is_cw_h,
            catchword_thresholds=self.catchword_thresholds,
            **extra,
        )
        self.is_training_complete = True

    def train_edge_topics(self) -> None:
        """Edge (compound) topics (src/trainer.cpp:673-685)."""
        assert self.is_training_complete, "train basic topics first"
        assert self.config.compute_edge_topics, "edge topic flag is off"
        t1, t2, valid = self.top_pairs
        self.edge_model, self.edge_pairs = construct_edge_topics_v2(
            t1,
            t2,
            valid,
            self.model,
            self.config.num_topics,
            self.config.max_edge_topics,
            min_docs=self.config.hyper.edge_topic_min_docs,
            primary_ratio=self.config.hyper.edge_topic_primary_ratio,
        )
        self.logger.info(f"#Edge topics: {self.edge_model.shape[1]}")
        self.timer.next("constructing edge topic model")

    # ------------------------------------------------------------------
    # Outputs (src/trainer.cpp:656-1040)
    # ------------------------------------------------------------------

    def write_model_to_file(self) -> None:
        assert self.is_training_complete
        io_text.write_sparse_model(
            os.path.join(self.run_dir, "M_hat_catch_sparse"), self.model
        )
        self.timer.next("output model")
        io_text.write_top_words(
            os.path.join(self.run_dir, "TopWordsPerTopic_catch.txt"),
            self.model,
            self.vocab_words,
            max(self.config.hyper.coherence_num_words, 10),
        )
        self.timer.next("output topwords")

    def write_edgemodel_to_file(self) -> None:
        if self.edge_model is None:
            return
        io_text.write_sparse_model(
            os.path.join(self.run_dir, "EdgeModel_sparse"), self.edge_model
        )
        io_text.write_edge_composition(
            os.path.join(self.run_dir, "EdgeTopicComposition.txt"),
            self.edge_pairs,
        )
        self.timer.next("output edge model")

    def output_doc_topic(self) -> None:
        """DocCatchword.tsv + DocTopicCatchwordSums.tsv
        (src/trainer.cpp:874-1010 `output_doc_topic`):

          - DocCatchword.tsv: one `<doc>\\t<word>\\t<normalized_val>` line
            per corpus entry whose word is a catchword of any topic,
            doc-major (1-based ids, ftoa 6-decimal float format).
          - DocTopicCatchwordSums.tsv: `<doc>\\t<topic>\\t<sum>` for every
            positive per-doc catchword-topic mass, ordered by (topic asc,
            sum desc) — the sort construct_topic_model applies before the
            writer runs (src/sparseMatrix.cpp:715-720).
        """
        assert self.is_training_complete
        from . import native
        from .topic_model import doc_topic_mass

        k = self.config.num_topics
        V = self.corpus.vocab_size
        D = self.corpus.num_docs
        cwt = np.full(V, -1, np.int32)
        for t in range(k):
            cwt[self.catchwords[t]] = t
        self.logger.info(
            f"Total number of catchwords: {int((cwt >= 0).sum())}"
        )
        rows = self.corpus.rows
        vals = self.corpus.vals
        doc_ids = self.corpus.doc_ids()
        mask = cwt[rows] >= 0
        native.write_float_triples(
            os.path.join(self.run_dir, "DocCatchword.tsv"),
            doc_ids[mask], rows[mask], vals[mask],
        )
        # Doc-topic catchword mass on device (one chunked scatter kernel
        # in place of a host np.add.at pass over every nnz).
        A = self._device_A()
        mass = np.asarray(doc_topic_mass(
            A, jnp.asarray(cwt), k, self.config.device.spmm_chunk
        ))
        dd, tt = np.nonzero(mass)
        vv = mass[dd, tt]
        order = np.lexsort((-vv, tt))
        native.write_float_triples(
            os.path.join(self.run_dir, "DocTopicCatchwordSums.tsv"),
            dd[order], tt[order], vv[order],
        )
        self.timer.next("writing document catchword weights")

    def print_top_two_topics(self) -> None:
        """TopTwoTopicsPerDoc.txt: `<doc>\\t<top1>\\t<top2>` (1-based),
        doc-ascending (src/trainer.cpp:1008-1040 mmap branch; the host
        sort by doc id is a no-op here because top_pairs is doc-indexed)."""
        assert self.top_pairs is not None, "train with compute_edge_topics"
        from . import native

        t1, t2, valid = self.top_pairs
        d = np.flatnonzero(valid).astype(np.int32)
        native.write_int_triples(
            os.path.join(self.run_dir, "TopTwoTopicsPerDoc.txt"),
            d, t1[d], t2[d],
        )
        self.timer.next("printing top 2 topics/doc")

    def output_topic_diversity(self) -> float:
        """Average squared distance of topic vectors to the mean topic
        vector (src/trainer.cpp:750-771). The reference's cross-term
        indexes topic 1's column for every t (`Model->data() +
        Model->vocab_size()` misses the `* t`, :766-767) — an obvious
        indexing slip in a log-only diagnostic; we compute the intended
        quantity."""
        assert self.is_training_complete
        from .diagnostics import topic_diversity

        div = topic_diversity(self.model)
        self.logger.info(f"Average topic diversity: {div:.6f}")
        self.timer.next("calculating diversity")
        return div

    def output_avg_topic_coherence(self) -> Tuple[float, np.ndarray]:
        """Coherence of the catchword-free cluster-average model
        (src/trainer.cpp:705-748): construct_topic_model with empty
        catchword lists (every topic takes its cluster average), coherence
        over its top words, M_hat_avg dense dump + TopWordsPerTopic_avg.txt.
        Returns (avg coherence, per-topic coherences)."""
        assert self.is_training_complete
        from .diagnostics import topic_coherence

        cfg = self.config
        k = cfg.num_topics
        A = self._device_A()
        cwt = jnp.full((self.corpus.vocab_size,), -1, jnp.int32)
        avg_model, _ = construct_topic_model(
            A,
            cwt,
            jnp.asarray(self.cluster_of_doc),
            k,
            cfg.hyper.model_rank_threshold(self.corpus.num_docs, k),
            chunk=cfg.device.spmm_chunk,
        )
        avg_model = np.asarray(avg_model)
        nl_coherences = topic_coherence(
            self.corpus, avg_model, cfg.hyper.coherence_num_words,
            cfg.hyper.coherence_eps,
        )
        avg = float(np.mean(nl_coherences))
        self.logger.info(f"Avg coherence without catchwords: {avg:.6f}")
        self.timer.next("computing coherence without catchwords")
        io_text.write_dense_model(
            os.path.join(self.run_dir, "M_hat_avg"), avg_model
        )
        self.timer.next("writing Mhat to file")
        io_text.write_top_words(
            os.path.join(self.run_dir, "TopWordsPerTopic_avg.txt"),
            avg_model,
            self.vocab_words,
            max(cfg.hyper.coherence_num_words, 10),
        )
        self.timer.next("writing top words to file")
        return avg, nl_coherences

    def output_cluster_summary(self) -> None:
        """Catchwords, top words, cluster details, coherence, topic
        diversity (src/trainer.cpp:776-829, 750-771)."""
        assert self.is_training_complete
        from .diagnostics import topic_coherence, topic_diversity

        k = self.config.num_topics
        nw = self.config.hyper.coherence_num_words
        tops = io_text.top_words_per_topic(self.model, max(nw, 10))
        coh = topic_coherence(
            self.corpus, self.model, nw, self.config.hyper.coherence_eps
        )
        sizes = np.bincount(
            self.cluster_of_doc[self.cluster_of_doc >= 0], minlength=k
        )
        for t in range(k):
            cw = self.catchwords[t] if self.catchwords else []
            words = ", ".join(self.vocab_words[w] for w, _ in tops[t][:10])
            self.logger.info(
                f"---- Topic {t}: cluster_size={sizes[t]} "
                f"#catchwords={len(cw)} coherence={coh[t]:.4f}\n"
                f"     top words: {words}"
            )
            # Catchword detail dump (LogUtils::print_catch_words,
            # include/logUtils.h:48-65): `word:id(threshold)` per
            # catchword, space-separated, threshold at %g precision.
            if len(cw) and self.catchword_thresholds is not None:
                thr_t = self.catchword_thresholds[t]
                detail = " ".join(
                    f"{self.vocab_words[w]}:{w}({thr_t[w]:.6g})" for w in cw
                )
                self.logger.diag(f"Catchwords:\n{detail} ")
        self.logger.info(f"Avg coherence: {float(np.mean(coh)):.4f}")
        self.logger.info(
            f"Average topic diversity: {topic_diversity(self.model):.6f}"
        )
        self.timer.next("output summary")

    def compute_input_svd(self) -> np.ndarray:
        """Spectrum of the raw normalized matrix A — the reference's
        diagnostic dump (src/trainer.cpp:409-423). Writes
        A_squared_spectrum.txt and returns the squared singular values."""
        A = self._device_A()
        k = self.config.num_topics
        res = block_ks(
            lambda A_, X: mat_gram_x(A_, X, self.config.device.spmm_chunk),
            self.corpus.vocab_size,
            k,
            op_data=A,
            blk=self.config.hyper.block_ks_block_size,
            tol=self.config.hyper.block_ks_tolerance,
            max_restarts=self.config.hyper.block_ks_max_iters,
            key=jax.random.PRNGKey(self.config.seed + 1),
        )
        path = os.path.join(self.run_dir, "A_squared_spectrum.txt")
        with open(path, "w") as f:
            for v in res.evals:
                f.write(f"{v:.8g}\n")
        self._print_eigen_data(res.evals, k)
        self.timer.next("input SVD diagnostic")
        return res.evals

    def print_log_combinatorial(self) -> None:
        """Per-doc log multinomial statistic dump
        (src/trainer.cpp:378-389)."""
        from .diagnostics import log_combinatorial

        vals = log_combinatorial(self.corpus)
        path = os.path.join(self.run_dir, "LogCombinatorial.txt")
        with open(path, "w") as f:
            for v in vals:
                f.write(f"{v:.6g}\n")
        self.timer.next("print log combinatorial")

    def print_distinct_top_five_sets(self) -> None:
        """Distinct top-5-word multiset counts (src/trainer.cpp:393-407)."""
        from .diagnostics import count_distinct_top_five

        counts = [
            count_distinct_top_five(self.corpus, m)
            for m in (2, 5, 10, 20, 50, 100, 200, 500)
        ]
        self.logger.info(
            "Distinct top five sets: " + " ".join(str(c) for c in counts)
        )
        self.timer.next("distinct top-5 words")

    def get_model(self) -> np.ndarray:
        """C-API GetBasicModel analog (drivers/trainer_export.cpp:70-78)."""
        assert self.is_training_complete
        return self.model

    def get_edge_model(self) -> Optional[np.ndarray]:
        return self.edge_model

    # ------------------------------------------------------------------

    def _print_eigen_data(self, evalues: np.ndarray, k: int) -> None:
        """Spectrum report (include/logUtils.h:101-122): singular values
        are sqrt of the Gram eigenvalues."""
        sv = np.sqrt(np.maximum(evalues, 0.0))
        self.logger.info(
            f"Singular values (top {min(5, k)}): "
            + ", ".join(f"{x:.4f}" for x in sv[:5])
            + f" ... lambda_k={sv[-1]:.4f}  sum={sv.sum():.2f}"
        )

    def _restore_model_checkpoint(self, ck: dict) -> bool:
        """Restore the final 'model' checkpoint (plus kmeans/svd context)
        into trainer state; True when training is already complete. The
        single place all three training entry points (in-core, sharded,
        streamed) unpack the checkpoint schema."""
        if "model" not in ck:
            return False
        k = self.config.num_topics
        m = ck["model"]
        self.model = m["model"]
        if "is_cw" in m:
            is_cw = m["is_cw"]
            self.catchwords = [np.flatnonzero(is_cw[t]) for t in range(k)]
            self.catchword_thresholds = m.get("catchword_thresholds")
        if "t1" in m:
            self.top_pairs = (m["t1"], m["t2"], m["valid"])
        if "kmeans" in ck:
            self.centers = ck["kmeans"]["centers"]
            self.cluster_of_doc = ck["kmeans"]["cluster_of_doc"]
        if "svd" in ck:
            self.evalues = ck["svd"]["evalues"]
            self.original_cols = ck["svd"]["original_cols"]
        self.logger.info("resumed from 'model' checkpoint")
        self.is_training_complete = True
        return True

    def _corpus_stamp(self) -> np.ndarray:
        """(vocab, num_docs, nnz) fingerprint stamped into every stage
        checkpoint: resuming with a checkpoint from a DIFFERENT corpus
        (same config hash, changed data) would otherwise silently train
        on stale zetas/U — e.g. a shorter checkpointed zetas vector makes
        _keep_mask's clamped gather drop every word id beyond it with no
        error."""
        c = self.corpus
        return np.array([c.vocab_size, c.num_docs, c.nnz], np.int64)

    def _load_checkpoints(self) -> dict:
        out = {}
        stamp = self._corpus_stamp() if self.corpus is not None else None
        for stage in ("svd", "kmeans", "model"):
            path = os.path.join(self.run_dir, f"ckpt_{stage}.npz")
            if os.path.exists(path):
                ck = dict(np.load(path, allow_pickle=False))
                got = ck.pop("corpus_stamp", None)
                if (stamp is not None and got is not None
                        and not np.array_equal(got, stamp)):
                    raise ValueError(
                        f"checkpoint '{stage}' in {self.run_dir} was "
                        f"written for a different corpus "
                        f"(vocab/docs/nnz {got.tolist()} vs "
                        f"{stamp.tolist()}); delete the stale "
                        "checkpoints or train without resume"
                    )
                out[stage] = ck
                self.logger.diag(f"found checkpoint '{stage}' at {path}")
        return out

    def _checkpoint(self, stage: str, **arrays) -> None:
        path = os.path.join(self.run_dir, f"ckpt_{stage}.npz")
        # UNcompressed: zlib costs seconds per stage for the ~40 MB
        # float32 payloads (U, centers, model) for a ~10% size saving.
        arrays = {k: v for k, v in arrays.items() if v is not None}
        if self.corpus is not None:
            arrays["corpus_stamp"] = self._corpus_stamp()
        np.savez(path, **arrays)
        self.logger.diag(f"checkpointed stage '{stage}' -> {path}")
