"""`python -m drtvam_tpu_torch config.json` — the CLI entry point."""
from .opt.optimize import main

main()
