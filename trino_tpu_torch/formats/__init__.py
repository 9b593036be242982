"""File format libraries (port copies of ``trino_tpu/formats/``)."""
