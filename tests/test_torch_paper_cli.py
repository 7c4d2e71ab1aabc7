"""The paper tables' CPU smoke: ``python -m repro_torch.paper --quick
--device cpu`` exits 0 and prints ``benchmarks/run.py``'s CSV, one line
per quick row of Tables II, III and V, each with a DSP reduction of at
least 1x.
"""
import re

from tests.test_torch_paper_tables import run_module

ROWS = ["table2_jets_rf2_dsp", "table2_jets_rf8_dsp", "table3_svhn_rf3",
        "table5_lenet_md"]


def test_paper_tables_quick_cpu_smoke():
    out = run_module("repro_torch.paper", "--quick", "--device", "cpu",
                     timeout=600)
    lines = out.strip().splitlines()
    assert lines[0] == "name,us_per_call,derived"
    assert [ln.split(",")[0] for ln in lines[1:]] == ROWS, out
    for ln in lines[1:]:
        name, us, derived = ln.split(",")
        assert int(us) > 0, ln
        dsp = re.match(r"dsp_red=(\S+)x ", derived)
        assert dsp and float(dsp.group(1)) >= 1.0, ln
        assert re.search(r"acc=\d\.\d{3}->\d\.\d{3}", derived), ln
        if name.startswith(("table2", "table5")):
            assert re.search(r" bram_red=\S+x ", derived), ln
