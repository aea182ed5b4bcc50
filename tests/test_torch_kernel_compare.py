"""``experiments/torch_ssd_compare.py``, the tool that runs one smoke phase's
kernels for a source tree on the card: its reading of the ptxas report
(``--ptxas``) keeps each phase's own entry functions and their registers
and spills, and nothing of the other kernels'. The rest of the tool needs
a card."""
import importlib.util
from pathlib import Path

import pytest

_spec = importlib.util.spec_from_file_location(
    "torch_ssd_compare",
    Path(__file__).resolve().parents[1] / "experiments" /
    "torch_ssd_compare.py")
compare = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(compare)

# the shape of ``ptxas -v``'s report: per entry function its name, its
# stack and spills, its registers
ENTRIES = {
    "fa": "_ZN12_GLOBAL__N_112fa_fwd_wgmmaILi32EEEvNS_8TileMapsE",
    "ssd": "_Z13ssd_chunk_outI13__nv_bfloat16EvPKT_PKf",
    "wkv": "_Z13wkv_chunk_bwdIfEvPKT_S2_",
    "gmm": "_ZN43_GLOBAL__N__36b24e7b_10_moe_gmm_cu_2dbdb9688gmm_tf32ILb0E"
           "Lb1EEEvNS_7GmmArgsE",
    "carry": "_Z11chunk_carryPfS_PKfiii",
}


def _report(tmp_path) -> Path:
    lines = []
    for i, name in enumerate(ENTRIES.values()):
        lines += [
            f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'",
            f"ptxas info    : Function properties for {name}",
            f"    {8 * i} bytes stack frame, {8 * i} bytes spill stores, "
            f"{8 * i} bytes spill loads",
            f"ptxas info    : Used {100 + i} registers, used 1 barriers"]
    path = tmp_path / "ptxas.log"
    path.write_text("\n".join(lines) + "\n")
    return path


@pytest.mark.parametrize("phase,entry", [("6", "fa"), ("8", "ssd"),
                                         ("11", "wkv"), ("14", "gmm")])
def test_ptxas_lines_keep_the_phase_kernels(tmp_path, phase, entry):
    stem, prefix = compare.PHASES[phase]
    assert stem == entry
    got = compare.ptxas_lines(_report(tmp_path), prefix)
    i = list(ENTRIES).index(entry)
    assert got == [
        f"Compiling entry function '{ENTRIES[entry]}' for 'sm_90a'",
        f"    {8 * i} bytes stack frame, {8 * i} bytes spill stores, "
        f"{8 * i} bytes spill loads",
        f"Used {100 + i} registers, used 1 barriers"]
