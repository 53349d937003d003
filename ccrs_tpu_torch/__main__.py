"""``python -m ccrs_tpu_torch <dataset> ...``: the calibration CLI."""

from .cli import main

if __name__ == "__main__":
    main()
