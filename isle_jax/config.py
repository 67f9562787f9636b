"""Run-time configuration for isle-jax.

Mirrors the reference's compile-time constants (reference:
include/hyperparams.h:8-82, include/types.h:23-86, include/parallel.h:11)
as a dataclass so runs are reproducible without recompilation, plus
device-mapping knobs (mesh shape, memory budgets, chunk sizes) that have
no counterpart in the reference.

Defaults match the reference exactly unless marked [device].
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class HyperParams:
    """Algorithm constants of the TSVD topic-model pipeline.

    Names and defaults follow reference include/hyperparams.h:8-82.
    """

    # Provable-algorithm constants (hyperparams.h:8-12).
    w0: float = 1.0
    eps1: float = 1.0 / 60.0
    eps2: float = 1.0 / 3.0
    rho: float = 1.1
    eps3: float = 5.0

    # USE_INT_NORMALIZED_COUNTS (hyperparams.h:14; include/types.h:82-86).
    # True selects the reference's count_t pipeline: normalized values are
    # ceil(avg_doc_sz * count / doc_sum) stored as integers (the FPTYPE
    # path computes the product in fp and rounds later, in the threshold
    # walk). Default false, matching the reference build.
    use_int_normalized_counts: bool = False

    # FEW_SAMPLES_THRESHOLD_DROP (hyperparams.h:16-21): when a word occurs
    # in fewer docs than count_gr, drop the word entirely (zeta = +inf;
    # the reference writes FP_MAX / 1<<31) instead of "throw everything
    # in" (zeta = 1). Default false, matching the reference build.
    few_samples_threshold_drop: bool = False

    # BAD_THRESHOLD_DROP (hyperparams.h:23-25): when the downward zeta
    # walk exhausts (reaches the last distinct value, or value 1, without
    # satisfying the tie cap), drop the word (zeta = +inf) instead of
    # zeta = 1. Default false, matching the reference build.
    bad_threshold_drop: bool = False

    # Eigensolver (hyperparams.h:31-40). "block_ks" is the default in the
    # reference; "dense" runs the full dense eigendecomposition oracle
    # (the reference's compare_LAPACK_Spectra pattern,
    # src/denseMatrix.cpp:413-461) and is only sensible for small problems.
    eigensolver: str = "block_ks"
    block_ks_max_iters: int = 100
    # [device] The reference uses 10 (hyperparams.h:39). A Krylov block
    # that narrow leaves the accelerator's vector and matrix units nearly
    # idle and makes the gather-SpMM latency bound, so we default to 128. The
    # convergence criterion (per-eigenpair relative residual < tol) is
    # unchanged, so results agree to tolerance.
    block_ks_block_size: int = 128
    block_ks_tolerance: float = 1e-4
    # Strict convergence: raise if the eigensolver converges fewer than
    # nev pairs within the restart cap, as the reference's assert does
    # (src/sparseMatrix.cpp:1207). False logs a warning with the residual
    # diagnostics and proceeds with the best available subspace.
    block_ks_strict: bool = False

    # Streaming block size over documents (hyperparams.h:42).
    doc_block_size: int = 1 << 18

    # Materialize the projected matrix P = U^T B (hyperparams.h:44
    # USE_EXPLICIT_PROJECTED_MATRIX). True is the default (P is k x docs —
    # tiny next to B). False recomputes the projections one
    # doc block at a time (matops.mat_bt_x_blockwise), restoring the
    # reference's built-in A/B cross-check of the projection + projected
    # k-means stages (src/trainer.cpp:522-531).
    use_explicit_projected_matrix: bool = True

    # k-means configuration (hyperparams.h:46-68).
    kmeans_init_method: str = "kmeanspp"  # kmeanspp | kmeansbb | kmeansmcmc
    kmeans_init_reps: int = 1
    # AFK-MC^2 Markov-chain batch size (hyperparams.h:54
    # KMEANSMCMC_SAMPLE_SIZE, consumed at src/denseMatrix.cpp:790).
    kmeansmcmc_sample_size: int = 10000
    enable_kmeans_on_lowd: bool = True
    max_kmeans_lowd_reps: int = 10
    kmeans_algo_for_sparse: str = "lloyds"  # lloyds | elkans
    max_kmeans_reps: int = 10

    # Topic construction (hyperparams.h:72-79).
    avg_cluster_for_catchless_topic: bool = True
    edge_topic_min_docs: int = 1
    edge_topic_primary_ratio: float = 0.7

    # Coherence reporting (hyperparams.h:74-75).
    coherence_eps: float = 1e-5
    coherence_num_words: int = 5

    # Inference defaults (hyperparams.h:81-82; include/infer.h:52).
    infer_iters_default: int = 15
    infer_Lf_default: float = 10.0
    infer_max_guesses: int = 10  # Lf-doubling retries (src/infer.cpp:416)

    def count_gr(self, nz_docs: int, num_topics: int) -> int:
        """#(freqs > zeta) requirement (src/sparseMatrix.cpp:370)."""
        c = int(self.w0 * float(nz_docs) / (2.0 * float(num_topics)))
        return max(c, 1)

    def count_eq(self, nz_docs: int, num_topics: int) -> int:
        """#(freqs == zeta) cap (src/sparseMatrix.cpp:371)."""
        c = int(
            math.ceil(3.0 * self.eps1 * self.w0 * float(nz_docs) / float(num_topics))
        )
        return max(c, 1)

    def catchword_rank(
        self, num_docs: int, num_topics: int, sample_rate: Optional[float] = None
    ) -> int:
        """r for the r-th-highest catchword statistic (src/trainer.cpp:580-584)."""
        n = float(num_docs) if sample_rate is None else float(num_docs) * sample_rate
        return int(math.floor(self.eps2 * self.w0 * n / (2.0 * float(num_topics))))

    def model_rank_threshold(self, num_docs: int, num_topics: int) -> int:
        """Per-topic doc-sum rank threshold (src/sparseMatrix.cpp:722)."""
        return int(self.eps3 * self.w0 * float(num_docs) / (float(num_topics) * 2.0))


@dataclasses.dataclass(frozen=True)
class DeviceConfig:
    """[device] Hardware-mapping knobs; no reference counterpart."""

    # Mesh axis over the document dimension of the term-document matrix.
    # () means single-device execution.
    mesh_shape: Tuple[int, ...] = ()
    mesh_axis_names: Tuple[str, ...] = ("docs",)

    def mesh_devices(self) -> int:
        """Total devices requested by mesh_shape (1 = single-device)."""
        n = 1
        for s in self.mesh_shape:
            n *= int(s)
        return n
    # Chunk length for nnz-streamed SpMM fallback (entries per scan step).
    spmm_chunk: int = 1 << 21
    # Device-memory budget for the dense Zipf-head rows of the hybrid
    # SpMM layout (see hybrid.py); 0 disables the hybrid layout. The head
    # turns the most frequent words' gather/scatter traffic into dense
    # matmuls; the factored layout stores it at 2 bytes/cell (bf16
    # binary). Not yet sized for an 80 GB card.
    dense_head_bytes: int = 4096 << 20
    # Lift the int32 flat-scatter row cap on the dense head. When set,
    # head builds whose (rows+1)*(docs+1) index range exceeds int32
    # switch to doc-blocked scatters (hybrid._scatter_head): per column
    # block one extra nnz-length masked scatter at build time, ops over
    # the head unchanged. Pays only when the Zipf coverage curve is steep
    # enough that the extra rows buy real tail shrinkage. Raise
    # dense_head_bytes together with this.
    break_head_cap: bool = False
    # Run the eigensolver's restart loop on-device in one lax.while_loop
    # (no per-restart host syncs); False uses the host-driven loop with
    # per-restart diagnostics.
    device_loop_solver: bool = True
    # When set, Trainer.train() wraps the pipeline in a jax profiler
    # trace written to this directory (SURVEY.md §5.1's tracing story:
    # phase Timers + OpCounter FLOP rates + on-demand XLA traces).
    profile_dir: str = ""
    # Restart-warm eigensolver: when a prior 'svd' stage checkpoint exists
    # in the run directory, seed the Krylov start block with its U
    # (linalg._init_block) instead of random — retraining on the same or
    # drifted data then converges in fewer operator applications. Honored
    # by the in-core, sharded, and streamed trainers and by both Krylov
    # solvers (lanczos seeds its start vector from U[:, 0]). Off by
    # default: the benchmark headline and parity runs use cold starts.
    eigen_warm_start: bool = False
    # Streamed (out-of-core) mode: device-memory budget for keeping a
    # compact RESIDENT copy of the corpus (word ids int32 + counts in the
    # smallest dtype, ~5 B/entry — 3.9 GB at the PubMed shape) so the
    # host->device upload is paid ONCE instead of once per pass. 0
    # disables; oversized corpora fall back to per-pass streaming
    # automatically. Not yet sized for an 80 GB card.
    resident_corpus_bytes: int = 6 << 30
    # Usable device memory for layout planning; 0 reads the allocator's
    # limit from the device (memory_budget). The streamed trainer uses
    # it to decide whether the resident corpus slabs can stay held
    # across the hybrid/eigen/k-means middle — skipping the second fill
    # — with a correspondingly smaller dense head
    # (streaming.plan_middle_budget).
    hbm_bytes: int = 0

    def memory_budget(self, device=None) -> Optional[int]:
        """Device-memory budget in bytes: `hbm_bytes` when set, else the
        allocator's limit (`memory_stats()["bytes_limit"]`) of `device`
        (default: the first JAX device). None when neither exists — the
        CPU backend reports no limit, so callers there skip memory
        planning unless `hbm_bytes` is given."""
        if self.hbm_bytes > 0:
            return self.hbm_bytes
        if device is None:
            import jax

            device = jax.devices()[0]
        stats = device.memory_stats()
        if not stats or not stats.get("bytes_limit"):
            return None
        return int(stats["bytes_limit"])


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Everything `ISLETrain` takes on the CLI (drivers/ISLETrain.cpp:9-32)
    plus seeding (the reference uses unseeded rand(); we make determinism a
    feature) and hyperparameter/device overrides."""

    num_topics: int
    vocab_size: int = 0  # 0 = infer from data (src/trainer.cpp:249-261)
    num_docs: int = 0  # 0 = infer from data
    tf_idf: bool = False
    sample_docs: bool = False
    sample_rate: float = 0.0
    compute_edge_topics: bool = False
    max_edge_topics: int = 0
    seed: int = 0
    hyper: HyperParams = dataclasses.field(default_factory=HyperParams)
    device: DeviceConfig = dataclasses.field(default_factory=DeviceConfig)

    def log_dir_name(self) -> str:
        """Config-encoded run-directory name (src/utils.cpp:28-48)."""
        h = self.hyper
        return (
            f"log_t_{self.num_topics}_eps1_{h.eps1:.6f}_eps2_{h.eps2:.6f}"
            f"_eps3_{h.eps3:.6f}_rho_{h.rho:.2f}"
            f"_sample_{int(self.sample_docs)}_rate_{self.sample_rate:.3f}"
            f"_tfidf_{int(self.tf_idf)}_seed_{self.seed}"
        )


@dataclasses.dataclass(frozen=True)
class InferConfig:
    """Everything `ISLEInfer` takes on the CLI (drivers/ISLEInfer.cpp:10-36)."""

    num_topics: int
    vocab_size: int
    iters: int = 0  # 0 = INFER_ITERS_DEFAULT
    Lf: float = 0.0  # 0 = INFER_LF_DEAFULT
    hyper: HyperParams = dataclasses.field(default_factory=HyperParams)
    device: DeviceConfig = dataclasses.field(default_factory=DeviceConfig)

    def resolved_iters(self) -> int:
        return self.iters if self.iters > 0 else self.hyper.infer_iters_default

    def resolved_Lf(self) -> float:
        return self.Lf if self.Lf > 0.0 else self.hyper.infer_Lf_default
