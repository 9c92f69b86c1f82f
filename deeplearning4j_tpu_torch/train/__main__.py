"""`python -m deeplearning4j_tpu_torch.train`: see train/cli.py."""
from deeplearning4j_tpu_torch.train.cli import main

raise SystemExit(main())
