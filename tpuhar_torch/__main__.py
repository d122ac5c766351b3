"""``python -m tpuhar_torch``: the pipeline's command line (``cli.main``)."""
from .cli import main

if __name__ == "__main__":
    main()
