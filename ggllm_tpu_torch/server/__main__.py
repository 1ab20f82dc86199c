import sys

from ggllm_tpu_torch.server.app import main

if __name__ == "__main__":
    sys.exit(main())
