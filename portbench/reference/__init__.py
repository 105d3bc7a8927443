"""The plain generator and the plain receivers the program is judged
against; nothing here imports the program.

A configuration names its plain receiver with ``"reference": "<name>"``:
``reference/<name>.py``, which may define any of ``Modem``, ``Precision``,
``receive``, ``synchronize``, ``decode_bits`` and ``points`` with the
signatures of ``tables`` and ``rx`` (``registry.Receiver``); what it
leaves out, and every part of a configuration without the key, is
today's ``tables`` and ``rx``.  The harness, the check and the control
reach the receiver only through ``Registry.receiver``.
"""
