/* Lossless transcode of a JPEG file's coefficients into other codings, with
 * the system's libjpeg (jpeg_read_coefficients -> jpeg_write_coefficients).
 * Test tooling for the port's decoder tests; never part of the port.
 *
 *   transcode IN OUT [-a] [-p] [-r ROWS] [-s SCRIPT]
 *
 *   -a         arithmetic coding (SOF9, or SOF10 with -p or -s)
 *   -p         progressive, libjpeg's standard script (jpeg_simple_progression)
 *   -r ROWS    a restart interval of ROWS MCUs
 *   -s SCRIPT  progressive with this scan script: scans separated by ';',
 *              each "c0,c1,...:Ss:Se:Ah:Al"
 *
 * Build: gcc -O1 -o transcode transcode.c -ljpeg */

#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include <jpeglib.h>

static jpeg_scan_info scans[256];

static int parse_script(const char *s) {
  int n = 0;
  while (*s && n < 256) {
    jpeg_scan_info *sc = &scans[n];
    memset(sc, 0, sizeof *sc);
    for (;;) {
      sc->component_index[sc->comps_in_scan++] = (int)strtol(s, (char **)&s, 10);
      if (*s != ',') break;
      ++s;
    }
    if (sscanf(s, ":%d:%d:%d:%d", &sc->Ss, &sc->Se, &sc->Ah, &sc->Al) != 4) return -1;
    ++n;
    s = strchr(s, ';');
    if (!s) break;
    ++s;
  }
  return n;
}

int main(int argc, char **argv) {
  int arith = 0, progressive = 0, restart = 0, nscans = 0;
  if (argc < 3) {
    fprintf(stderr, "usage: transcode IN OUT [-a] [-p] [-r ROWS] [-s SCRIPT]\n");
    return 2;
  }
  for (int i = 3; i < argc; ++i) {
    if (!strcmp(argv[i], "-a")) arith = 1;
    else if (!strcmp(argv[i], "-p")) progressive = 1;
    else if (!strcmp(argv[i], "-r") && i + 1 < argc) restart = atoi(argv[++i]);
    else if (!strcmp(argv[i], "-s") && i + 1 < argc) {
      nscans = parse_script(argv[++i]);
      if (nscans <= 0) {
        fprintf(stderr, "bad scan script\n");
        return 2;
      }
    } else {
      fprintf(stderr, "unknown argument %s\n", argv[i]);
      return 2;
    }
  }
  FILE *in = fopen(argv[1], "rb"), *out = fopen(argv[2], "wb");
  if (!in || !out) {
    perror("transcode");
    return 1;
  }
  struct jpeg_decompress_struct src;
  struct jpeg_compress_struct dst;
  struct jpeg_error_mgr jsrcerr, jdsterr;
  src.err = jpeg_std_error(&jsrcerr);
  jpeg_create_decompress(&src);
  dst.err = jpeg_std_error(&jdsterr);
  jpeg_create_compress(&dst);
  jpeg_stdio_src(&src, in);
  jpeg_read_header(&src, TRUE);
  jvirt_barray_ptr *coefs = jpeg_read_coefficients(&src);
  jpeg_copy_critical_parameters(&src, &dst);
  dst.arith_code = arith ? TRUE : FALSE;
  dst.optimize_coding = FALSE;
  if (nscans) {
    dst.scan_info = scans;
    dst.num_scans = nscans;
  } else if (progressive) {
    jpeg_simple_progression(&dst);
  }
  dst.restart_interval = (unsigned)restart;
  jpeg_stdio_dest(&dst, out);
  jpeg_write_coefficients(&dst, coefs);
  jpeg_finish_compress(&dst);
  jpeg_destroy_compress(&dst);
  jpeg_finish_decompress(&src);
  jpeg_destroy_decompress(&src);
  fclose(in);
  fclose(out);
  return 0;
}
