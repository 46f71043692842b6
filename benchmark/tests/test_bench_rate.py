"""The rate interval: from the window's start to the last burst end
before the deadline."""

from benchmark.drive import rate_interval


def test_cuts_at_the_last_whole_burst():
    # bursts of 3 windows at t=1 and t=2; one in progress at the deadline
    s = [(0.0, 0, 0), (1.00, 1, 1), (1.01, 2, 2), (1.02, 3, 3),
         (2.00, 4, 4), (2.01, 5, 5), (2.02, 6, 6),
         (2.99, 7, 7), (3.01, 8, 8), (3.5, 8, 8)]
    assert rate_interval(s, 0.0, 3.0, 0.25) == (6, 2.02)


def test_every_completion_with_no_gap():
    s = [(0.0, 0, 0), (0.5, 1, 1), (1.0, 2, 2), (1.6, 3, 3), (2.5, 3, 3)]
    assert rate_interval(s, 0.0, 2.0, 0.0) == (3, 1.6)


def test_staging_errors_do_not_end_a_burst():
    # an error counted at staging (ok unchanged) is no cut point
    s = [(0.0, 0, 0), (1.0, 2, 2), (1.5, 3, 2), (2.2, 4, 2), (2.3, 6, 4),
         (3.5, 6, 4)]
    assert rate_interval(s, 0.0, 3.0, 0.25) == (6, 2.3)


def test_a_pass_end_is_a_cut():
    s = [(0.0, 0, 0), (1.0, 2, 2), (1.1, 3, 3), (1.1001, 3, 3), (3.0, 3, 3)]
    assert rate_interval(s, 0.0, 2.0, 0.25, pass_ends=[1.1001]) == (3, 1.1001)


def test_no_burst_in_the_window():
    s = [(0.0, 0, 0), (2.5, 3, 3), (3.0, 3, 3)]
    assert rate_interval(s, 0.0, 2.0, 0.25) is None


def test_an_error_after_a_burst_does_not_hide_its_end():
    # the burst ending at 2.0 is followed within the gap by an error
    # counted at staging: the burst still ends there
    s = [(0.0, 0, 0), (1.0, 2, 2), (2.0, 4, 4), (2.1, 5, 4), (3.5, 5, 4)]
    assert rate_interval(s, 0.0, 3.0, 0.25) == (4, 2.0)
