"""isle-infer CLI — same positional contract as the reference ISLEInfer
(drivers/ISLEInfer.cpp:10-36):

    python -m isle_jax.cli.infer <sparse_model_file> <infer_file>
        <output_dir> <num_topics> <vocab_size>
        <min_doc_id> <max_doc_id> <nnzs_in_infer_file>
        <nnzs_in_sparse_model_file> <iters|0> <Lf|0>
"""

from __future__ import annotations

import sys


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) != 11:
        print(
            "Usage: python -m isle_jax.cli.infer <sparse_model_file> "
            "<infer_file> <output_dir> <num_topics> <vocab_size> "
            "<min_doc_id> <max_doc_id> <nnzs_in_infer_file> "
            "<nnzs_in_model_file> <iters|0 for default> <Lf|0 for default>",
            file=sys.stderr,
        )
        return 1

    from isle_jax.config import InferConfig
    from isle_jax.inferencer import Inferencer
    from isle_jax.obs import enable_compilation_cache

    enable_compilation_cache()

    (
        model_file,
        infer_file,
        output_dir,
        num_topics,
        vocab_size,
        doc_begin,
        doc_end,
        max_entries,
        _model_entries,
        iters,
        Lf,
    ) = argv
    cfg = InferConfig(
        num_topics=int(num_topics),
        vocab_size=int(vocab_size),
        iters=int(iters),
        Lf=float(Lf),
    )
    inf = Inferencer(cfg, model_file=model_file, output_dir=output_dir)
    result = inf.infer_file(
        infer_file,
        doc_begin=int(doc_begin),
        doc_end=int(doc_end),
        max_entries=int(max_entries) or None,
    )
    inf.timer.report_total("ISLEInfer")
    return 0


if __name__ == "__main__":
    sys.exit(main())
