"""CLI entry points mirroring the reference drivers (ISLETrain/ISLEInfer)."""
