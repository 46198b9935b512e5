"""``python -m oasisx_tpu_torch``: the command-line entry point."""

from .main import main

if __name__ == "__main__":
    main()
