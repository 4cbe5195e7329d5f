"""The kinds of timed call, one module each, found by the ``call`` that a
traffic file names (``benchmark/calls/<call>.py``).

A module gives:

* ``inputs(config, traffic, seed, device)``: the pool of inputs, made on
  ``device`` from ``seed``; call ``i`` takes input ``i mod len(pool)``;
* ``make_call(config, traffic, span)``: the call the window repeats, input
  in, the outputs the check judges out (a dict of tensors), with
  ``span(name)`` around each layer it enters;
* ``reference(x, config, traffic, dtype)``: the plain reference's outputs
  for the input ``x``, computed in ``dtype`` (by default ``x``'s, the
  configuration's, for the check; the precision below it for the
  control);
* ``numbers(x, out, want)``: the compared numbers of one call, the
  program's outputs against the reference's; the traffic's ``limits``
  hold one limit for each;
* ``FAULTS`` and ``plant(call, kind, config)``: the faults of the timed
  path that the check has to catch, planted under the call.

A kind of call that a later cell needs is a new module here; no file of
the harness names the kinds.
"""
