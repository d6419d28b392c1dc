import sys

from llm_training_tpu_torch.cli.main import main

sys.exit(main())
