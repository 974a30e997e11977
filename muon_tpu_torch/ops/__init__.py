"""Device compute layer of the port: device resolution, sparse kernels, linear algebra."""
