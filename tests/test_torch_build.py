"""The build key of the kernel libraries covers every header a source can
include: an edit to the shared quantizer header must rebuild every library
that includes it. No ``nvcc`` is needed: the key is computed from the files."""
import os
import shutil
from pathlib import Path

import pytest

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import kernel as fk
from repro_torch.kernels.quantize_em import kernel as qk
from repro_torch.kernels.rwkv6 import kernel as wk

ROOT = Path(__file__).resolve().parents[1]
HEADER = _build.INCLUDE_DIR / "quantize_em.cuh"
LIBRARIES = {"quantize_em": qk, "flash_attention": fk, "wkv6": wk}


@pytest.mark.parametrize("name", sorted(LIBRARIES))
def test_every_library_depends_on_the_shared_header(name):
    mod = LIBRARIES[name]
    deps = _build.key_files([mod._SOURCE])
    assert deps[0] == mod._SOURCE.resolve()
    assert HEADER.resolve() in deps
    assert len(deps) == len(set(deps))
    assert str(mod._SOURCE.resolve().relative_to(ROOT)) == mod.SOURCE


@pytest.mark.parametrize("name", sorted(LIBRARIES))
def test_editing_the_header_changes_the_library_name(name, tmp_path):
    """Copy the source and the shared header, edit the header only: the key
    (and with it the library's file name) changes; restoring it gives the
    first key back."""
    mod = LIBRARIES[name]
    src_dir, inc_dir = tmp_path / "csrc", tmp_path / "include"
    src_dir.mkdir()
    inc_dir.mkdir()
    src = src_dir / mod._SOURCE.name
    shutil.copy(mod._SOURCE, src)
    header = inc_dir / HEADER.name
    shutil.copy(HEADER, header)
    flags = list(_build.NVCC_FLAGS) + list(qk._FLAGS)
    before = _build._key([src], flags, [inc_dir])
    text = header.read_text()
    header.write_text(text.replace("kQuietNaN = 0x7FC00000u",
                                   "kQuietNaN = 0x7FC00001u"))
    after = _build._key([src], flags, [inc_dir])
    assert after != before
    header.write_text(text)
    assert _build._key([src], flags, [inc_dir]) == before


def test_a_header_beside_the_source_is_hashed_too(tmp_path):
    """Every file beside the source and in the include directories is part
    of the key, whether or not it is included yet."""
    (tmp_path / "a").mkdir()
    (tmp_path / "inc").mkdir()
    src = tmp_path / "a" / "k.cu"
    src.write_text('#include "x.cuh"\nint f();\n')
    (tmp_path / "a" / "x.cuh").write_text("// beside the source\n")
    (tmp_path / "inc" / "y.cuh").write_text("// shared\n")
    assert _build.key_files([src], [tmp_path / "inc"]) == [
        src.resolve(), (tmp_path / "a" / "x.cuh").resolve(),
        (tmp_path / "inc" / "y.cuh").resolve()]
    key = _build._key([src], [], [tmp_path / "inc"])
    (tmp_path / "a" / "x.cuh").write_text("// beside the source, edited\n")
    assert _build._key([src], [], [tmp_path / "inc"]) != key
    key = _build._key([src], [], [tmp_path / "inc"])
    (tmp_path / "inc" / "y.cuh").write_text("// shared, edited\n")
    assert _build._key([src], [], [tmp_path / "inc"]) != key


def test_flags_are_the_quantizers_for_every_library():
    """The fused epilogues run the quantizer's device code, so every library
    is built with its no-contraction, no-flush flags."""
    for mod in LIBRARIES.values():
        assert mod._FLAGS is qk._FLAGS or tuple(mod._FLAGS) == qk._FLAGS
    assert {"-ftz=false", "-prec-div=true", "-fmad=false"} <= set(qk._FLAGS)
    assert "compute_90a,code=sm_90a" in " ".join(_build.NVCC_FLAGS)
    assert os.path.isfile(HEADER)
