"""Problem families, one module a kind: ``kinds/<kind>.py``, picked by
the configuration's ``instance.kind`` and found by file name
(``manifest.kind``).  A kind module owns what is particular to its
family, and the harness (``run.py``, ``capture.py``, ``check.py``,
``faults.py``, ``control.py``) names no kind:

* ``make(seed, index, **params)``: pool instance ``index`` under
  ``seed`` from the configuration's instance parameters (``m_pad`` and
  ``n_pad`` left out); sent to spawn workers by import path, so keep
  what its module imports light;
* ``save(path, instances)`` and ``load(path)``: a pool in the pool
  cache;
* ``variables(instance)``: the variables an instance counts;
* ``upload(port, instances, instance_cfg, device)``: the pool laid out
  on the device, returned as ``gather(idx)``, the problem object an
  entry is given for a batch of pool indices;
* ``Capture(rec, check, pick)``: what the recorder keeps for the check
  (``wraps()``: the program functions it wraps; ``batch()``: a new
  batch; ``work()``: kernel work by ``work.KERNELS`` group in traced
  runs), planned from the traffic's ``check`` and the seed's stream
  ``pick``;
* ``FAULTS``: which of ``faults.NAMES`` apply, each as the program
  functions it replaces;
* ``RefPool(instances, instance_cfg, device)`` and ``numbers(ref,
  batches, captured, rec, cfg, ckpt, control, witness)``: the
  reference's own pool and every compared number; ``infeasible``, the
  answers that break the configuration's guarantees, is the run's
  ``failed``.
"""
