"""Offline preprocessing (counterpart of ``vlsat_tpu/preprocess``): depth
visibility (``depth``), rescan alignment (``transform``) and the
relationship-JSON scene splitting (``gen_data``)."""
