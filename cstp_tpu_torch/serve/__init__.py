"""Serving of the port: int8 calibration (``serve/quantize.py``) and the
exported eval program with its runtime (``serve/export.py``)."""

from cstp_tpu_torch.serve.export import (  # noqa: F401
    ServingModel,
    export_serving_artifact,
    save_serving_artifact,
)
