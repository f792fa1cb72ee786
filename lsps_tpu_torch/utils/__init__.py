"""Host utilities of the port: skeleton tables, logging, visualization."""
