from tpubwa_torch.native.build import as_ptr, load_native  # noqa: F401
