"""Job kinds of the benchmark, one file each: cnvbench/jobs/<kind>.py.

A traffic file names its kind under ``"job"`` ("engine" where it has no
such key); run.py loads the kind's file by path, as it loads a metric's
reader, so that a new kind is a new file.  A kind module gives:

``SETUP_PARTS``
    the names of the two set-up parts timed before the warm jobs: the
    draw, then the system with its keep and facts.
``draw(config, traffic, seed, device)``
    the traffic's data, drawn from the seed.
``port(config, traffic, data, device)``
    the system under test: ``job(j, sample, keep, slot, spans)`` runs job
    ``j`` on ``sample`` and returns what the check compares where ``slot``
    is not None (else None); ``spans`` (trace.Spans) labels its calls.
``control(config, traffic, data, device)``
    the same job by the plain reference at the precision below the
    configuration's: the tests put it in the port's place and the
    comparison must refuse it.
``keep(config, traffic, data, system, seed, device)``
    which of the window's jobs the check keeps: ``offer(j)`` gives the
    job's slot or None.
``facts(config, traffic, data, system, traced)``
    a dict of what the metric readers take from ``ctx`` beside the
    window's own numbers: ``samples`` (job j runs sample j modulo it) and
    ``cells_per_job`` always, and whatever the kind's readers need.
``compare(config, traffic, data, results, device)``
    the numbers that cnvbench/limits/<workload>.json bounds, over the kept
    jobs' results in slot order, once the program's state is freed.
"""
