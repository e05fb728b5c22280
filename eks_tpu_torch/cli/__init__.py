"""Command-line interface of eks-tpu-torch (one subcommand per smoother family)."""
