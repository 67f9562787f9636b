"""isle-train CLI — same positional contract as the reference ISLETrain
(drivers/ISLETrain.cpp:8-51):

    python -m isle_jax.cli.train <tdf_file> <vocab_file> <output_dir>
        <vocab_size> <num_docs> <max_entries> <num_topics>
        <tf_idf 0/1> <sample 0/1> <sample_rate>
        <edge_topics 0/1> <max_edge_topics> [--seed N]
"""

from __future__ import annotations

import sys


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    seed = 0
    if "--seed" in argv:
        i = argv.index("--seed")
        seed = int(argv[i + 1])
        del argv[i : i + 2]
    if len(argv) != 12:
        print(
            "Usage: python -m isle_jax.cli.train <tdf_file> <vocab_file> "
            "<output_dir> <vocab_size> <num_docs> <max_entries> <num_topics> "
            "<tf_idf 0/1> <sample 0/1> <sample_rate> <edge_topics 0/1> "
            "<max_edge_topics> [--seed N]",
            file=sys.stderr,
        )
        return 1

    from isle_jax.config import TrainConfig
    from isle_jax.obs import enable_compilation_cache
    from isle_jax.trainer import Trainer

    enable_compilation_cache()

    (
        tdf_file,
        vocab_file,
        output_dir,
        vocab_size,
        num_docs,
        max_entries,
        num_topics,
        tf_idf,
        sample,
        sample_rate,
        edge_topics,
        max_edge_topics,
    ) = argv

    cfg = TrainConfig(
        num_topics=int(num_topics),
        vocab_size=int(vocab_size),
        num_docs=int(num_docs),
        tf_idf=bool(int(tf_idf)),
        sample_docs=bool(int(sample)),
        sample_rate=float(sample_rate),
        compute_edge_topics=bool(int(edge_topics)),
        max_edge_topics=int(max_edge_topics),
        seed=seed,
    )
    trainer = Trainer(cfg, output_dir=output_dir, vocab_file=vocab_file)
    trainer.load_data_from_file(tdf_file)
    trainer.train()
    trainer.output_cluster_summary()
    trainer.write_model_to_file()
    # Doc-topic artifacts: the reference has these writers behind
    # commented/flag-gated call sites (src/trainer.cpp:663-666, :697-698);
    # they are cheap here, so a run directory is a superset of the
    # reference's.
    trainer.output_doc_topic()
    trainer.output_topic_diversity()
    if cfg.compute_edge_topics:
        trainer.train_edge_topics()
        trainer.write_edgemodel_to_file()
        trainer.print_top_two_topics()
    trainer.timer.report_total("ISLETrain")
    print(f"Model written to {trainer.run_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
