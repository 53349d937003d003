"""Example scripts of the port, runnable as ``python -m
ccrs_tpu_torch.examples.<name>``: ``convert_model`` (model conversion +
undistortion) and ``test_pnp`` (detect -> PnP -> undistortion).  PNGs go
through :mod:`ccrs_tpu_torch.pngio`."""
