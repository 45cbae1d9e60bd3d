"""The end-to-end readers take all of the window's work over all of its
time: every kernel over every answered signature, every answer inside
the window over the window's seconds."""

from portbench import harness


def readings(window_device):
    recs = [harness.Rec("mempool", 0, 0.0, 1.0, b"\x01" * 976),
            harness.Rec("mempool", 1, 0.5, 10.5, b"\x01" * 976),  # answered after the close
            harness.Rec("consensus", 0, 2.0, 2.1, b"\x01" * 34),
            harness.Rec("mempool", 2, 3.0, 4.0, None, "an error")]
    return harness.Readings(10.0, 1.0, {}, recs, {"counters": {}, "histograms": {}}, 50,
                            window_device=window_device)


def reader(name):
    return harness._reader(harness.ROOT, name)


def test_card_kernel_time_is_every_kernel_over_every_answered_signature():
    dev = [("ladder_kernel", "kernel", 0.0, 200.0), ("h_digits_kernel", "kernel", 300.0, 86.0),
           ("Memcpy HtoD", "gpu_memcpy", 10.0, 5000.0)]
    assert reader("card_kernel_ns_per_sig")(readings(dev)) == 1e3 * 286.0 / (976 * 2 + 34)


def test_card_kernel_time_is_absent_without_a_profiled_window():
    assert reader("card_kernel_ns_per_sig")(readings(None)) is None
    assert reader("card_kernel_ns_per_sig")(readings([("Memcpy HtoD", "gpu_memcpy", 0.0, 1.0)])) is None


def test_the_services_rate_counts_answers_inside_the_window():
    assert reader("service.verified_sigs_per_s")(readings(None)) == (976 + 34) / 10.0
