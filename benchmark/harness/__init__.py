"""The benchmark's cell runners: ``common`` (what every cell shares) and one
module a configuration's ``system`` names (``rx``, ``radio``), each with a
``Cell`` that sets up, runs the window and checks what it produced."""
