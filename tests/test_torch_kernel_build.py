"""The kernel libraries' names (``longlive_torch/ops/kernels.py``): a hash
of each ``csrc`` source and of the ``csrc/*.cuh`` headers it includes, so
that an edited header rebuilds every library that includes it.  CPU only:
nothing is compiled."""

from longlive_torch.ops import kernels


def _tree(root, header_text):
    (root / "sm90.cuh").write_text(header_text)
    (root / "uses.cu").write_text('#include "sm90.cuh"  // helpers\nint f() { return 1; }\n')
    (root / "alone.cu").write_text("#include <stdint.h>\nint g() { return 2; }\n")


def test_lib_path_hashes_included_headers(tmp_path, monkeypatch):
    monkeypatch.setattr(kernels, "_CSRC", tmp_path)
    _tree(tmp_path, "#pragma once\nint helper();\n")
    uses, alone = kernels._lib_path("uses"), kernels._lib_path("alone")
    assert uses.name.startswith("libuses-") and uses.suffix == ".so"
    (tmp_path / "sm90.cuh").write_text("#pragma once\nint helper(int);\n")
    assert kernels._lib_path("uses") != uses  # the header changed: a new library
    assert kernels._lib_path("alone") == alone  # it includes no header
    (tmp_path / "alone.cu").write_text("#include <stdint.h>\nint g() { return 3; }\n")
    assert kernels._lib_path("alone") != alone


def test_every_kernel_has_a_library_name():
    """Every shipped source and the headers it includes resolve."""
    names = {kernels._lib_path(name).name for name in kernels.KERNELS}
    assert len(names) == len(kernels.KERNELS)


def test_lib_path_hashes_nested_headers(tmp_path, monkeypatch):
    """A header included by an included header enters the hash too
    (``conv_sm90.cuh`` includes ``sm90.cuh``); a header included twice is
    read once."""
    monkeypatch.setattr(kernels, "_CSRC", tmp_path)
    _tree(tmp_path, "#pragma once\nint helper();\n")
    (tmp_path / "mid.cuh").write_text('#pragma once\n#include "sm90.cuh"\n')
    (tmp_path / "nested.cu").write_text('#include "mid.cuh"\n#include "sm90.cuh"\nint h();\n')
    nested = kernels._lib_path("nested")
    (tmp_path / "sm90.cuh").write_text("#pragma once\nint helper(int);\n")
    assert kernels._lib_path("nested") != nested
    assert kernels._headers(b'#include "mid.cuh"\n') == [b"mid.cuh", b"sm90.cuh"]
