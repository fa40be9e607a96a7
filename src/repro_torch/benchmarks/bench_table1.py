"""Paper Table 1: the SPRING design point, echoed with derived peaks so
the analytical model's constants are auditable (port of
``benchmarks/bench_table1.py``).

    python -m repro_torch.benchmarks.bench_table1

Rows: derived = the design parameter value.
"""

from __future__ import annotations

from repro_torch.perfmodel.spring_model import GPU_1080TI, SPRING_DESIGN


def rows() -> list[tuple[str, float, float]]:
    d = SPRING_DESIGN
    return [
        ("table1.clock_mhz", 0.0, d.clock_hz / 1e6),
        ("table1.n_pe", 0.0, d.n_pe),
        ("table1.mac_lanes_per_pe", 0.0, d.mac_lanes_per_pe),
        ("table1.muls_per_lane", 0.0, d.muls_per_lane),
        ("table1.peak_tmacs", 0.0, d.peak_macs / 1e12),
        ("table1.weight_buffer_mb", 0.0, d.weight_buffer_bytes / 1e6),
        ("table1.act_buffer_mb", 0.0, d.act_buffer_bytes / 1e6),
        ("table1.mask_buffer_mb", 0.0, d.mask_buffer_bytes / 1e6),
        ("table1.il_bits", 0.0, d.il_bits),
        ("table1.fl_bits", 0.0, d.fl_bits),
        ("table1.rram_tb_per_s", 0.0, d.mem_bw / 1e12),
        ("table1.gpu_peak_tflops", 0.0, GPU_1080TI.peak_flops / 1e12),
        ("table1.gpu_mem_gb_per_s", 0.0, GPU_1080TI.mem_bw / 1e9),
    ]


def main() -> None:
    print("name,us_per_call,derived")
    for name, us, derived in rows():
        print(f"{name},{us},{derived:.6g}")


if __name__ == "__main__":
    main()
