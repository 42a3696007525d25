"""Datasets and the ELL sparse layout on torch (counterpart of
``repro.data``)."""
