/* The JPEG writer of the layout fixtures: libjpeg(-turbo)'s compressor with
 * every knob that PIL does not expose, for files that PIL decodes but never
 * writes.  Built and run by make_fixtures.py only:
 *
 *   gcc -O2 jpeg_writer.c -ljpeg -o jpeg_writer
 *   jpeg_writer IN.raw OUT.jpg W H NCOMP SPACE QUALITY ARITH PROGRESSIVE
 *               RESTART_MCUS RESTART_ROWS SAMPLING DAC SCANS
 *
 * IN.raw holds H x W x NCOMP bytes: grey, RGB or CMYK as SPACE says
 * ("grey", "ycc" = RGB written as YCbCr, "rgb" = RGB kept, "cmyk", "ycck" =
 * CMYK written as YCCK).  SAMPLING is "HxV,HxV,..." per component ("-"
 * keeps libjpeg's defaults).  DAC is "-" or "tbl:L:U:K,..." (the DC
 * conditioning L and U and the AC Kx of arithmetic table tbl; tbl is also
 * used as the DC and AC table of the component of that index).  SCANS is
 * "-" (one interleaved sequential scan, or libjpeg's progressive script) or
 * "c0.c1:Ss:Se:Ah:Al;..." (a scan script; the first component indices of a
 * scan, joined by dots).
 */

#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include <jpeglib.h>

int main(int argc, char** argv) {
  if (argc != 15) {
    fprintf(stderr, "usage: see the header of jpeg_writer.c\n");
    return 2;
  }
  const char* in_path = argv[1];
  const char* out_path = argv[2];
  int w = atoi(argv[3]), h = atoi(argv[4]), nc = atoi(argv[5]);
  const char* space = argv[6];
  int quality = atoi(argv[7]), arith = atoi(argv[8]), progressive = atoi(argv[9]);
  int restart_mcus = atoi(argv[10]), restart_rows = atoi(argv[11]);
  const char* sampling = argv[12];
  const char* dac = argv[13];
  const char* scans = argv[14];

  size_t n = (size_t)w * h * nc;
  unsigned char* pixels = malloc(n);
  FILE* f = fopen(in_path, "rb");
  if (!f || fread(pixels, 1, n, f) != n) {
    fprintf(stderr, "cannot read %s\n", in_path);
    return 1;
  }
  fclose(f);

  struct jpeg_compress_struct cinfo;
  struct jpeg_error_mgr jerr;
  cinfo.err = jpeg_std_error(&jerr);
  jpeg_create_compress(&cinfo);
  FILE* out = fopen(out_path, "wb");
  jpeg_stdio_dest(&cinfo, out);
  cinfo.image_width = w;
  cinfo.image_height = h;
  cinfo.input_components = nc;
  if (!strcmp(space, "grey"))
    cinfo.in_color_space = JCS_GRAYSCALE;
  else if (nc == 4)
    cinfo.in_color_space = JCS_CMYK;
  else
    cinfo.in_color_space = JCS_RGB;
  jpeg_set_defaults(&cinfo);
  if (!strcmp(space, "rgb")) jpeg_set_colorspace(&cinfo, JCS_RGB);
  if (!strcmp(space, "cmyk")) jpeg_set_colorspace(&cinfo, JCS_CMYK);
  if (!strcmp(space, "ycck")) jpeg_set_colorspace(&cinfo, JCS_YCCK);
  jpeg_set_quality(&cinfo, quality, TRUE);
  cinfo.arith_code = arith ? TRUE : FALSE;
  cinfo.restart_interval = restart_mcus;
  cinfo.restart_in_rows = restart_rows;
  if (strcmp(sampling, "-")) {
    const char* p = sampling;
    for (int c = 0; c < cinfo.num_components; ++c) {
      int hs, vs;
      if (sscanf(p, "%dx%d", &hs, &vs) != 2) return 2;
      cinfo.comp_info[c].h_samp_factor = hs;
      cinfo.comp_info[c].v_samp_factor = vs;
      p = strchr(p, ',');
      if (!p) break;
      ++p;
    }
  }
  if (strcmp(dac, "-")) {
    const char* p = dac;
    while (p && *p) {
      int tbl, l, u, k;
      if (sscanf(p, "%d:%d:%d:%d", &tbl, &l, &u, &k) != 4) return 2;
      cinfo.arith_dc_L[tbl] = (UINT8)l;
      cinfo.arith_dc_U[tbl] = (UINT8)u;
      cinfo.arith_ac_K[tbl] = (UINT8)k;
      if (tbl < cinfo.num_components) {
        cinfo.comp_info[tbl].dc_tbl_no = tbl;
        cinfo.comp_info[tbl].ac_tbl_no = tbl;
      }
      p = strchr(p, ',');
      if (p) ++p;
    }
  }
  static jpeg_scan_info script[64];
  if (strcmp(scans, "-")) {
    int ns = 0;
    const char* p = scans;
    while (p && *p && ns < 64) {
      jpeg_scan_info* s = &script[ns++];
      s->comps_in_scan = 0;
      while (1) {
        s->component_index[s->comps_in_scan++] = (int)strtol(p, (char**)&p, 10);
        if (*p != '.') break;
        ++p;
      }
      if (sscanf(p, ":%d:%d:%d:%d", &s->Ss, &s->Se, &s->Ah, &s->Al) != 4) return 2;
      p = strchr(p, ';');
      if (p) ++p;
    }
    cinfo.scan_info = script;
    cinfo.num_scans = ns;
  } else if (progressive) {
    jpeg_simple_progression(&cinfo);
  }

  jpeg_start_compress(&cinfo, TRUE);
  while (cinfo.next_scanline < cinfo.image_height) {
    JSAMPROW row = pixels + (size_t)cinfo.next_scanline * w * nc;
    jpeg_write_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_compress(&cinfo);
  jpeg_destroy_compress(&cinfo);
  fclose(out);
  free(pixels);
  return 0;
}
